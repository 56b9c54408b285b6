"""Scoring (PyTorch): the end-to-end mel -> CNN-BiLSTM scorer, and
streaming file scoring over the decoders of ``io``."""

from audioanalysisdetector_tpu_torch.score.e2e import (
    init_mel_cnn_bilstm,
    make_mel_cnn_bilstm_scorer,
    melspec_features,
)
from audioanalysisdetector_tpu_torch.score.streaming import score_paths, stream_decode_batches

__all__ = [
    "init_mel_cnn_bilstm",
    "make_mel_cnn_bilstm_scorer",
    "melspec_features",
    "score_paths",
    "stream_decode_batches",
]
