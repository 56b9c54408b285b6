"""EDA-notebook spectrogram variants (PyTorch).

Counterpart of the JAX package's ``frontend/eda.py``: the exploration
notebook's high-resolution CQT spectrogram (``compute_cqt_spec``:
n_bins=108, bins_per_octave=36, dB ref=max, per-utterance z-norm —
ASV_dataset.ipynb cell 29) and the z-normalized 128-mel spectrogram
(n_fft=2048, hop=512 — cell 27), whose mel power runs through the kernel
``frontend.mel.mel_route`` names on a CUDA tensor (K3 at these settings).
"""

from __future__ import annotations

import torch

from audioanalysisdetector_tpu_torch.frontend.cqt import C1_HZ, CQTConfig, cqt
from audioanalysisdetector_tpu_torch.frontend.db import amplitude_to_db, power_to_db
from audioanalysisdetector_tpu_torch.frontend.mel import MelConfig, melspectrogram


def znorm(x: torch.Tensor, *, utt_axes: int = 2, eps: float = 1e-6) -> torch.Tensor:
    """Per-utterance z-normalization over the trailing spectrogram axes
    (the population std, as ``jnp.std``)."""
    dims = tuple(range(-utt_axes, 0))
    mean = torch.mean(x, dim=dims, keepdim=True)
    std = torch.std(x, dim=dims, keepdim=True, correction=0)
    return (x - mean) / (std + eps)


def compute_cqt_spec(
    y: torch.Tensor,
    *,
    sr: int = 16000,
    hop_length: int = 512,
    n_bins: int = 108,
    bins_per_octave: int = 36,
    fmin: float = C1_HZ,
) -> torch.Tensor:
    """(…, n) -> (…, 108, T): |CQT| -> dB(ref=max) -> z-norm."""
    cfg = CQTConfig(sr=sr, hop_length=hop_length, fmin=fmin, n_bins=n_bins, bins_per_octave=bins_per_octave)
    return znorm(amplitude_to_db(cqt(y, cfg), ref="max", utt_axes=2))


def melspectrogram_znorm(
    y: torch.Tensor,
    *,
    sr: int = 16000,
    n_mels: int = 128,
    n_fft: int = 2048,
    hop_length: int = 512,
) -> torch.Tensor:
    """(…, n) -> (…, 128, T): mel power -> dB(ref=max) -> z-norm."""
    cfg = MelConfig(sr=sr, n_mels=n_mels, n_fft=n_fft, hop_length=hop_length)
    return znorm(power_to_db(melspectrogram(y, cfg), ref="max", utt_axes=2))
