"""Delta features and CMVN (librosa-parity, batched, PyTorch).

Counterpart of the part of the JAX package's ``frontend/mfcc.py`` that the
fused GMM arm needs (``train/gmm_system.py``'s frame transform): ``delta``,
``add_deltas`` and ``cmvn``. Deltas follow ``librosa.feature.delta``
(Savitzky-Golay, ``width=9``, ``mode='interp'``), folded into one host-built
``(T, T)`` operator applied as a GEMM; ``_savgol_delta_matrix`` is a copy of
the JAX package's. ``mfcc`` itself, ``MFCCConfig`` and ``mfcc_deltas_cmvn``
wait for ROADMAP Queue 1 step 10 (the remaining frontends).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


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
