"""Training-side utilities (PyTorch port): checkpoint reading, host
metrics, and the load and evaluation side of the GMM-UBM system. Training
itself waits for ROADMAP Queue 1 steps 7-8."""

from audioanalysisdetector_tpu_torch.train.checkpoint import MsgpackFormatError, load_payload
from audioanalysisdetector_tpu_torch.train.gmm_system import (
    add_sequence_deltas,
    eval_model,
    load_bilstm_model,
    load_gmm_feature_fn,
    load_gmm_models,
    make_gmm_feature_fn,
    sequence_cmvn,
)
from audioanalysisdetector_tpu_torch.train.metrics import (
    accuracy,
    eer,
    eer_threshold,
    f1_binary,
    f1_macro,
    model_result_metrics,
    roc_curve_np,
)

__all__ = [
    "MsgpackFormatError",
    "accuracy",
    "add_sequence_deltas",
    "eer",
    "eer_threshold",
    "eval_model",
    "f1_binary",
    "f1_macro",
    "load_bilstm_model",
    "load_gmm_feature_fn",
    "load_gmm_models",
    "load_payload",
    "make_gmm_feature_fn",
    "model_result_metrics",
    "roc_curve_np",
    "sequence_cmvn",
]
