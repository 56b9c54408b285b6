"""Scoring (PyTorch): the end-to-end mel -> CNN-BiLSTM scorer."""

from audioanalysisdetector_tpu_torch.score.e2e import (
    init_mel_cnn_bilstm,
    make_mel_cnn_bilstm_scorer,
    melspec_features,
)

__all__ = ["init_mel_cnn_bilstm", "make_mel_cnn_bilstm_scorer", "melspec_features"]
