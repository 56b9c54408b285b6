"""Models (PyTorch): the CNN-BiLSTM hybrid and its LSTM layers."""

from audioanalysisdetector_tpu_torch.models.cnn_bilstm import CNNBiLSTMHybrid
from audioanalysisdetector_tpu_torch.models.lstm import BiLSTM, LSTMLayer

__all__ = ["BiLSTM", "CNNBiLSTMHybrid", "LSTMLayer"]
