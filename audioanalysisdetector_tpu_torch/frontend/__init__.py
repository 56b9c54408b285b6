"""Batched DSP frontends (PyTorch): STFT power, mel, dB."""

from audioanalysisdetector_tpu_torch.frontend.db import amplitude_to_db, power_to_db
from audioanalysisdetector_tpu_torch.frontend.mel import (
    MelConfig,
    log_mel_spectrogram,
    mel_filterbank,
    melspectrogram,
)
from audioanalysisdetector_tpu_torch.frontend.stft import (
    frame_signal,
    n_frames_for,
    power_spectrogram,
)

__all__ = [
    "MelConfig",
    "amplitude_to_db",
    "frame_signal",
    "log_mel_spectrogram",
    "mel_filterbank",
    "melspectrogram",
    "n_frames_for",
    "power_spectrogram",
    "power_to_db",
]
