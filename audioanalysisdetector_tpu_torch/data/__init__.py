"""Data utilities (PyTorch port): frame standardization, length bucketing."""

from audioanalysisdetector_tpu_torch.data.bucketing import (
    bucket_for,
    bucketed_batches,
    make_bucket_ladder,
)
from audioanalysisdetector_tpu_torch.data.scaler import FrameScaler

__all__ = ["FrameScaler", "bucket_for", "bucketed_batches", "make_bucket_ladder"]
