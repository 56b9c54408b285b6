"""Models (PyTorch): the CNN-BiLSTM hybrid, the fused system's BiLSTM
classifier, the diagonal GMM (scoring, EM, MAP), and their LSTM layers."""

from audioanalysisdetector_tpu_torch.models.bilstm_classifier import BiLSTMClassifier
from audioanalysisdetector_tpu_torch.models.cnn_bilstm import CNNBiLSTMHybrid
from audioanalysisdetector_tpu_torch.models.gmm import (
    DiagGMM,
    component_log_prob,
    compute_llr,
    fit_em,
    from_numpy,
    log_weighted,
    map_adapt,
    masked_llr,
    predict_proba,
    score,
    score_samples,
    to_numpy,
)
from audioanalysisdetector_tpu_torch.models.layers import flax_init_
from audioanalysisdetector_tpu_torch.models.lstm import BiLSTM, LSTMLayer

__all__ = [
    "BiLSTM",
    "BiLSTMClassifier",
    "CNNBiLSTMHybrid",
    "DiagGMM",
    "LSTMLayer",
    "component_log_prob",
    "compute_llr",
    "fit_em",
    "flax_init_",
    "from_numpy",
    "log_weighted",
    "map_adapt",
    "masked_llr",
    "predict_proba",
    "score",
    "score_samples",
    "to_numpy",
]
