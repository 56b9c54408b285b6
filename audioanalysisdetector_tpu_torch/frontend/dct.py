"""Orthonormal DCT-II as a matmul basis (PyTorch).

Counterpart of the JAX package's ``frontend/dct.py``:
``scipy.fftpack.dct(type=2, norm='ortho')`` (the reference's CQCC step,
reference/ASV_dl_func.py:471) as a host-built basis applied with one GEMM.
``dct_ii_matrix`` is a copy of the JAX package's, so both packages use the
same float64 basis.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


@lru_cache(maxsize=None)
def dct_ii_matrix(n: int, n_out: int | None = None) -> np.ndarray:
    """Orthonormal DCT-II matrix ``(n_out, n)``: ``c = M @ x``.

    ``M[k, j] = s_k * cos(pi * k * (2j + 1) / (2n))`` with
    ``s_0 = sqrt(1/n)``, ``s_k = sqrt(2/n)`` for k > 0.
    """
    n_out = n if n_out is None else n_out
    k = np.arange(n_out)[:, None]
    j = np.arange(n)[None, :]
    M = np.cos(np.pi * k * (2.0 * j + 1.0) / (2.0 * n))
    M *= np.sqrt(2.0 / n)
    M[0] *= np.sqrt(0.5)
    return M


@lru_cache(maxsize=None)
def _matrix_on(n: int, n_out: int | None, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    with torch.inference_mode(False):  # cached: a normal tensor, usable where autograd records
        return torch.from_numpy(dct_ii_matrix(n, n_out)).to(device, dtype)


def dct_ii(x: torch.Tensor, *, axis: int = -2, n_out: int | None = None) -> torch.Tensor:
    """Orthonormal DCT-II along ``axis``, optionally truncated to ``n_out``."""
    M = _matrix_on(x.shape[axis], n_out, x.device, x.dtype)
    return (x.movedim(axis, -1) @ M.T).movedim(-1, axis)
