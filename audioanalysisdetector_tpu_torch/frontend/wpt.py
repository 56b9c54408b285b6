"""Wavelet-packet energies (db4, depth 3) — the reference's WPT feature (PyTorch).

Counterpart of the JAX package's ``frontend/wpt.py``. ``extract_wpt``
(reference/ASV_dl_func.py:502-519) computes ``pywt.WaveletPacket(data=y,
wavelet='db4', mode='symmetric', maxlevel=3)`` and returns the mean squared
energy of each of the 8 level-3 nodes in *natural* order (depth-first,
approximation child first).

The Mallat cascade with pywt's conventions: half-sample symmetric extension
(the edge sample repeated, numpy's ``mode="symmetric"``, taken by index:
torch's ``F.pad`` has no such mode, and its ``reflect`` leaves the edge
out), full convolution subsampled at odd indices, output length
``floor((n + L - 1) / 2)`` per level. Each level is one stride-2
``conv1d`` against the reversed 8-tap db4 decomposition pair (``conv1d`` is
a correlation, as ``lax.conv`` is). ``_DB4_REC_LO`` and
``db4_decomposition_filters`` are copies of the JAX package's.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

# db4 scaling (reconstruction low-pass) filter, standard published values.
_DB4_REC_LO = np.array(
    [
        0.23037781330885523,
        0.7148465705525415,
        0.6308807679295904,
        -0.02798376941698385,
        -0.18703481171888114,
        0.030841381835986965,
        0.032883011666982945,
        -0.010597401784997278,
    ]
)


@lru_cache(maxsize=None)
def db4_decomposition_filters() -> tuple[np.ndarray, np.ndarray]:
    """(dec_lo, dec_hi) pywt-convention decomposition pair for db4."""
    rec_lo = _DB4_REC_LO
    dec_lo = rec_lo[::-1].copy()
    # pywt QMF convention (even length): dec_hi[n] = (-1)**(n+1) * rec_lo[n]
    dec_hi = rec_lo * (-1.0) ** (np.arange(len(rec_lo)) + 1)
    return dec_lo, dec_hi


@lru_cache(maxsize=None)
def _symmetric_index(n: int, pad: int, device: torch.device) -> torch.Tensor:
    """Source index of numpy's ``mode="symmetric"`` pad of ``pad`` samples a
    side (the edge sample repeated; any ``n``, as ``jnp.pad`` takes)."""
    return torch.from_numpy(np.pad(np.arange(n), (pad, pad), mode="symmetric")).to(device)


@lru_cache(maxsize=None)
def _filters_on(device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """The reversed (dec_lo, dec_hi) pair as ``conv1d`` weights ``(2, 1, L)``."""
    dec_lo, dec_hi = db4_decomposition_filters()
    filt = np.stack([dec_lo[::-1], dec_hi[::-1]])[:, None, :]
    return torch.from_numpy(np.ascontiguousarray(filt)).to(device, dtype)


def _dwt_level(x: torch.Tensor, filt: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One analysis level along the last axis: (..., n) -> 2 x (..., (n+L-1)//2)."""
    L = filt.shape[-1]
    n = x.shape[-1]
    out_len = (n + L - 1) // 2
    # symmetric extension, then pywt's odd-index subsampling of the full convolution
    ext = x[..., _symmetric_index(n, L - 1, x.device)][..., 1:]
    out = F.conv1d(ext.reshape(-1, 1, ext.shape[-1]), filt, stride=2)[..., :out_len]
    out = out.reshape(x.shape[:-1] + (2, out_len))
    return out[..., 0, :], out[..., 1, :]


def wavelet_packet_leaves(y: torch.Tensor, *, level: int = 3) -> list[torch.Tensor]:
    """All 2**level terminal nodes in natural order (depth-first, 'a' first)."""
    filt = _filters_on(y.device, y.dtype)

    def descend(x: torch.Tensor, depth: int) -> list[torch.Tensor]:
        if depth == 0:
            return [x]
        a, d = _dwt_level(x, filt)
        return descend(a, depth - 1) + descend(d, depth - 1)

    return descend(y, level)


def wpt_energies(y: torch.Tensor, *, level: int = 3) -> torch.Tensor:
    """Mean squared energy of each terminal node: (..., n) -> (..., 2**level)."""
    leaves = wavelet_packet_leaves(y, level=level)
    return torch.stack([torch.mean(leaf * leaf, dim=-1) for leaf in leaves], dim=-1)
