"""CQCC — constant-Q cepstral coefficients (the reference's flagship feature), PyTorch.

Counterpart of the JAX package's ``frontend/cqcc.py``, the chain of
``extract_cqcc`` (reference/ASV_dl_func.py:442-481):

  CQT magnitude -> ``amplitude_to_db(ref=max)`` (per utterance)
  -> per-frame linear re-interpolation of the geometric frequency grid onto
     a LINEAR grid of the same size (one host-built ``(n_bins, n_bins)``
     operator, a GEMM)
  -> ``log(x**2 + 1e-12)`` applied to the *dB* values (a reference quirk,
     kept as part of the numeric contract)
  -> orthonormal DCT-II over the frequency axis, the first ``n_ceps=19`` rows.

A 2-s 16 kHz chunk with hop 512 gives ``(19, 63)``, the shape every
downstream model relies on. The quirk amplifies small errors: near 0 dB
(the bin at each utterance's max, where a regrid row lands on it) the log's
slope reaches 1/sqrt(1e-12) = 1e6, so two fp32 chains agree there only as
far as their dB maps do. ``_linear_regrid_matrix`` is a copy of the JAX
package's.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache

import numpy as np
import torch

from audioanalysisdetector_tpu_torch.frontend.cqt import CQTConfig, cqt, cqt_frequencies
from audioanalysisdetector_tpu_torch.frontend.db import amplitude_to_db
from audioanalysisdetector_tpu_torch.frontend.dct import dct_ii


@lru_cache(maxsize=None)
def _linear_regrid_matrix(n_bins: int, fmin: float, bins_per_octave: int) -> np.ndarray:
    """(n_bins, n_bins) matrix mapping geometric-grid values to a linear grid.

    Row i holds the two interpolation weights for linear target frequency i.
    End points coincide with the source grid, so no extrapolation occurs.
    """
    src = cqt_frequencies(n_bins, fmin, bins_per_octave)
    dst = np.linspace(src.min(), src.max(), num=n_bins)
    W = np.zeros((n_bins, n_bins))
    idx = np.searchsorted(src, dst, side="right") - 1
    idx = np.clip(idx, 0, n_bins - 2)
    frac = (dst - src[idx]) / (src[idx + 1] - src[idx])
    rows = np.arange(n_bins)
    W[rows, idx] = 1.0 - frac
    W[rows, idx + 1] = frac
    return W


@lru_cache(maxsize=None)
def _regrid_on(cqt_cfg: CQTConfig, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    W = _linear_regrid_matrix(cqt_cfg.n_bins, cqt_cfg.fmin, cqt_cfg.bins_per_octave)
    with torch.inference_mode(False):  # cached: a normal tensor, usable where autograd records
        return torch.from_numpy(W).to(device, dtype)


@dataclass(frozen=True)
class CQCCConfig:
    cqt: CQTConfig = field(default_factory=CQTConfig)
    n_ceps: int = 19

    @staticmethod
    def for_sr(sr: int, hop_length: int = 512, n_ceps: int = 19) -> "CQCCConfig":
        return CQCCConfig(cqt=CQTConfig.for_sr(sr, hop_length), n_ceps=n_ceps)


def cqcc_from_cqt_mag(mag: torch.Tensor, cfg: CQCCConfig = CQCCConfig()) -> torch.Tensor:
    """CQCC from a magnitude CQT ``(..., n_bins, T)`` -> ``(..., n_ceps, T)``."""
    db = amplitude_to_db(mag, ref="max", utt_axes=2)
    interp = _regrid_on(cfg.cqt, mag.device, mag.dtype) @ db
    log_power = torch.log(interp * interp + 1e-12)
    return dct_ii(log_power, axis=-2, n_out=cfg.n_ceps)


def cqcc(y: torch.Tensor, cfg: CQCCConfig = CQCCConfig()) -> torch.Tensor:
    """CQCC of ``(..., n)`` waveforms -> ``(..., n_ceps, T)`` (19, 63 for 2 s).

    On the card, where ``ops/cqcc.py::takes`` holds (float32, the default
    configuration, a length that is a multiple of 64 up to 32,704, no
    backward to come), one launch of K5; otherwise the plain chain."""
    # imported here: ops/cqcc.py builds its tables from this module's operators
    from audioanalysisdetector_tpu_torch.ops import cqcc as k5

    if k5.takes(y, cfg):
        return k5.cqcc_kernel(y, cfg)
    return cqcc_from_cqt_mag(cqt(y, cfg.cqt), cfg)


def transpose_cqcc(feat: torch.Tensor) -> torch.Tensor:
    """(…, n_ceps, T) -> (…, T, n_ceps): time-major layout for sequence models
    (the reference's ``transpose_cqcc``, reference/ASV_dl_func.py:1052-1062)."""
    return feat.transpose(-1, -2)
