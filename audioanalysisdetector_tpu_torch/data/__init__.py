"""Data pipeline (PyTorch port): metadata ingestion, chunking, balancing,
augmentation, batched feature extraction, frame standardization, length
bucketing and the synthetic surrogate corpus. Tables are lists of row dicts
(no pandas)."""

from audioanalysisdetector_tpu_torch.data.augment import (
    AUG_CODES,
    add_noise,
    apply_augmentations,
    pitch_shift,
    resample_to,
    spec_augment,
    time_shift,
    time_stretch,
)
from audioanalysisdetector_tpu_torch.data.balance import (
    add_data_augmentation,
    balance_downsample,
    balance_upsample,
    filtr_nan,
)
from audioanalysisdetector_tpu_torch.data.bucketing import (
    bucket_for,
    bucketed_batches,
    make_bucket_ladder,
)
from audioanalysisdetector_tpu_torch.data.dataset import (
    chunk_rows,
    prepare_dataframe,
    prepare_dirs_dataset,
)
from audioanalysisdetector_tpu_torch.data.metadata import (
    detect_columns,
    prepare_filepaths,
    read_metadata,
)
from audioanalysisdetector_tpu_torch.data.pipeline import (
    default_extractors,
    extract_feature_array,
    extract_features,
)
from audioanalysisdetector_tpu_torch.data.scaler import FrameScaler, prepare_train_test_data
from audioanalysisdetector_tpu_torch.data.shape_utils import prepare_data_gmm_bilstm

__all__ = [
    "AUG_CODES",
    "FrameScaler",
    "add_data_augmentation",
    "add_noise",
    "apply_augmentations",
    "balance_downsample",
    "balance_upsample",
    "bucket_for",
    "bucketed_batches",
    "chunk_rows",
    "default_extractors",
    "detect_columns",
    "extract_feature_array",
    "extract_features",
    "filtr_nan",
    "make_bucket_ladder",
    "pitch_shift",
    "prepare_data_gmm_bilstm",
    "prepare_dataframe",
    "prepare_dirs_dataset",
    "prepare_filepaths",
    "prepare_train_test_data",
    "read_metadata",
    "resample_to",
    "spec_augment",
    "time_shift",
    "time_stretch",
]
