"""Scoring (PyTorch): the end-to-end mel -> CNN-BiLSTM scorer, the fused
CQCC -> GMM ⊕ BiLSTM scorer, and streaming file scoring over the decoders
of ``io``."""

from audioanalysisdetector_tpu_torch.score.e2e import (
    init_mel_cnn_bilstm,
    make_cqcc_fused_scorer,
    make_e2e_train_step_inputs,
    make_mel_cnn_bilstm_scorer,
    melspec_features,
)
from audioanalysisdetector_tpu_torch.score.fused import (
    arm_scores,
    eval_fused,
    fit_decision_threshold,
    fit_llr_calibration,
    fused_scores,
    ieee_fp32,
    make_arm_scorer,
    make_fused_scorer,
    padding_mask,
)
from audioanalysisdetector_tpu_torch.score.streaming import score_paths, stream_decode_batches

__all__ = [
    "arm_scores",
    "eval_fused",
    "fit_decision_threshold",
    "fit_llr_calibration",
    "fused_scores",
    "ieee_fp32",
    "init_mel_cnn_bilstm",
    "make_arm_scorer",
    "make_cqcc_fused_scorer",
    "make_e2e_train_step_inputs",
    "make_fused_scorer",
    "make_mel_cnn_bilstm_scorer",
    "melspec_features",
    "padding_mask",
    "score_paths",
    "stream_decode_batches",
]
