"""Training subsystem (PyTorch port): losses, optimizers, state, steps,
loops, checkpoints in the JAX package's format, metrics, the GMM-UBM
system (training, loading, evaluation) and the surrogate quality lane
(``train.quality``), the data-parallel step over the ranks of a
process group, and the ResNet sweep with the 3-feature and MobileNet-MFCA
drivers (``train.sweep``)."""

from audioanalysisdetector_tpu_torch.train.checkpoint import (
    MsgpackFormatError,
    load_payload,
    restore_checkpoint,
    restore_params,
    save_checkpoint,
    save_params,
)
from audioanalysisdetector_tpu_torch.train.gmm_system import (
    add_sequence_deltas,
    eval_model,
    load_bilstm_model,
    load_gmm_feature_fn,
    load_gmm_models,
    make_gmm_feature_fn,
    sequence_cmvn,
    train_gmm_system,
)
from audioanalysisdetector_tpu_torch.train.loop import (
    EpochLog,
    FitResult,
    batch_iter,
    bilstm_pipeline,
    evaluate,
    fit,
    fit_bucketed,
    would_use_dp,
)
from audioanalysisdetector_tpu_torch.train.losses import LOSSES, get_loss
from audioanalysisdetector_tpu_torch.train.metrics import (
    accuracy,
    eer,
    eer_tensor,
    eer_threshold,
    f1_binary,
    f1_macro,
    model_result_metrics,
    roc_curve_np,
)
from audioanalysisdetector_tpu_torch.train.optimizers import OPTIMIZERS, make_optimizer
from audioanalysisdetector_tpu_torch.train.state import TrainState, param_count
from audioanalysisdetector_tpu_torch.train.sweep import (
    train_3features,
    train_all_features,
    train_feature_model,
    train_mfca,
)
from audioanalysisdetector_tpu_torch.train.steps import (
    make_dp_train_step,
    make_eval_step,
    make_train_step,
    replicate,
    shard_batch,
)

__all__ = [
    "EpochLog",
    "FitResult",
    "LOSSES",
    "MsgpackFormatError",
    "OPTIMIZERS",
    "TrainState",
    "accuracy",
    "add_sequence_deltas",
    "batch_iter",
    "bilstm_pipeline",
    "eer",
    "eer_tensor",
    "eer_threshold",
    "eval_model",
    "evaluate",
    "f1_binary",
    "f1_macro",
    "fit",
    "fit_bucketed",
    "get_loss",
    "load_bilstm_model",
    "load_gmm_feature_fn",
    "load_gmm_models",
    "load_payload",
    "make_dp_train_step",
    "make_eval_step",
    "make_gmm_feature_fn",
    "make_optimizer",
    "make_train_step",
    "model_result_metrics",
    "param_count",
    "replicate",
    "restore_checkpoint",
    "restore_params",
    "roc_curve_np",
    "save_checkpoint",
    "save_params",
    "sequence_cmvn",
    "shard_batch",
    "train_3features",
    "train_all_features",
    "train_feature_model",
    "train_gmm_system",
    "train_mfca",
    "would_use_dp",
]
