"""MFCC + delta features + CMVN (librosa-parity, batched, PyTorch).

Counterpart of the JAX package's ``frontend/mfcc.py``. The reference's MFCC
is ``librosa.feature.mfcc(y, sr, n_mfcc=13)`` (reference/ASV_dl_func.py:416)
with librosa defaults: 128-mel power spectrogram -> ``power_to_db`` (ref=1,
top_db=80, the clip relative to the per-utterance max) -> orthonormal
DCT-II over the mel axis -> first ``n_mfcc`` rows. On a CUDA tensor the mel
power runs through the kernel ``frontend.mel.mel_route`` names (K3,
``ops/ct_mel``, at the default n_fft 2048 / hop 512).

Deltas follow ``librosa.feature.delta`` (Savitzky-Golay, ``width=9``,
``mode='interp'``), folded into one host-built ``(T, T)`` operator applied
as a GEMM; ``_savgol_delta_matrix`` is a copy of the JAX package's.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache

import numpy as np
import torch

from audioanalysisdetector_tpu_torch.frontend.db import power_to_db
from audioanalysisdetector_tpu_torch.frontend.dct import dct_ii
from audioanalysisdetector_tpu_torch.frontend.mel import MelConfig, melspectrogram


@dataclass(frozen=True)
class MFCCConfig:
    n_mfcc: int = 13
    mel: MelConfig = field(default_factory=lambda: MelConfig(n_mels=128))
    # librosa.feature.mfcc dB settings (power_to_db defaults)
    ref: float | str = 1.0
    top_db: float | None = 80.0

    @staticmethod
    def for_sr(sr: int, n_mfcc: int = 13) -> "MFCCConfig":
        return MFCCConfig(n_mfcc=n_mfcc, mel=MelConfig(sr=sr, n_mels=128))


def mfcc(y: torch.Tensor, cfg: MFCCConfig = MFCCConfig()) -> torch.Tensor:
    """MFCCs of ``(..., n)`` waveforms -> ``(..., n_mfcc, T)``."""
    S = power_to_db(melspectrogram(y, cfg.mel), ref=cfg.ref, top_db=cfg.top_db, utt_axes=2)
    return dct_ii(S, axis=-2, n_out=cfg.n_mfcc)


@lru_cache(maxsize=None)
def _savgol_delta_matrix(t: int, width: int, order: int) -> np.ndarray:
    """(t, t) matrix M with ``delta(x) = x @ M.T`` along a time axis of length t.

    Equals ``scipy.signal.savgol_filter(I, width, polyorder=order,
    deriv=order, mode='interp')`` applied column-wise — SG filtering is
    linear, so filtering the identity yields the exact operator, including
    'interp' edge behavior.
    """
    from scipy.signal import savgol_filter

    eye = np.eye(t)
    out = savgol_filter(eye, width, polyorder=order, deriv=order, axis=0, mode="interp")
    return out.astype(np.float64)


@lru_cache(maxsize=None)
def _delta_on(t: int, width: int, order: int, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    return torch.from_numpy(_savgol_delta_matrix(t, width, order)).to(device, dtype)


def delta(x: torch.Tensor, *, width: int = 9, order: int = 1, axis: int = -1) -> torch.Tensor:
    """librosa-parity delta features along ``axis`` (static length)."""
    t = x.shape[axis]
    if t < width:
        raise ValueError(f"sequence length {t} shorter than SG width {width}")
    M = _delta_on(t, width, order, x.device, x.dtype)
    return (x.movedim(axis, -1) @ M.T).movedim(-1, axis)


def add_deltas(feat: torch.Tensor, *, width: int = 9, axis: int = -1) -> torch.Tensor:
    """Stack [feat; delta; delta-delta] along the coefficient axis (-2)."""
    d1 = delta(feat, width=width, order=1, axis=axis)
    d2 = delta(feat, width=width, order=2, axis=axis)
    return torch.cat([feat, d1, d2], dim=-2)


def cmvn(
    feat: torch.Tensor, *, axis: int = -1, variance: bool = True, eps: float = 1e-8
) -> torch.Tensor:
    """Per-utterance cepstral mean (and variance) normalization over ``axis``
    (the population variance, as ``jnp.var``)."""
    out = feat - feat.mean(dim=axis, keepdim=True)
    if variance:
        out = out / torch.sqrt(feat.var(dim=axis, keepdim=True, correction=0) + eps)
    return out


def mfcc_deltas_cmvn(y: torch.Tensor, cfg: MFCCConfig = MFCCConfig(), *, width: int = 9) -> torch.Tensor:
    """BASELINE config #2: MFCC + delta/delta-delta + per-utterance CMVN.

    ``(..., n) -> (..., 3 * n_mfcc, T)``.
    """
    feat = add_deltas(mfcc(y, cfg), width=width, axis=-1)
    return cmvn(feat, axis=-1)
