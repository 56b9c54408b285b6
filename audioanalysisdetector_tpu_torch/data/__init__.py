"""Data utilities (PyTorch port): frame standardization."""

from audioanalysisdetector_tpu_torch.data.scaler import FrameScaler

__all__ = ["FrameScaler"]
