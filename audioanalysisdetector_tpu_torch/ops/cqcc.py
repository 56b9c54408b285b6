"""CQCC of raw fp32 waveforms in one launch: the hand-written Hopper kernel (K5).

The JAX package has no Pallas CQT (XLA computes it); this kernel replaces
the port's plain chain on the card, ``frontend/cqcc.py::cqcc`` over
``frontend/cqt.py::cqt`` (per-octave SGEMMs against mostly-zero operators,
banded decimation GEMMs over ``torch.cat`` copies, then the dB, regrid, log
and DCT passes), where ``takes`` holds of the input. It turns ``(..., n)``
waveforms into the ``(..., 19, T)`` CQCC with every level, map and sum in
shared memory. Design and bound: the note in ``ops/csrc/cqcc.cu``.

Its tables are the plain path's cached host operators, laid out for the
kernel by ``host_tables``: each octave's bank (``_octave_kernel_bank``)
cut to each bin's support, widened to whole 4-tap chunks; the half-band
taps (``_halfband_fir``); the two weights of each row of
``_linear_regrid_matrix``; the DCT-II rows (``dct_ii_matrix``). The card
takes them in float32, as the plain path does.

``cqcc_kernel`` launches the kernel on a CUDA tensor, under the
``cqcc.kernel`` span, counted as ``cqcc``. There is no fallback: a failed
build or a refused launch raises. The plain version is ``cqcc()`` itself:
on an input ``refusals`` names a reason for, ``cqcc()`` runs it.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from audioanalysisdetector_tpu_torch.frontend.cqt import (
    _NUMTAPS,
    CQTConfig,
    _halfband_fir,
    _octave_kernel_bank,
)
from audioanalysisdetector_tpu_torch.frontend.dct import dct_ii_matrix
from audioanalysisdetector_tpu_torch.ops import _build, launch, on_card
from audioanalysisdetector_tpu_torch.utils.profiling import span

N_CEPS = 19
OCTAVES, BINS = 7, 12
CHUNK = 4  # taps a float4 load covers
MIN_PHASES = 16  # a lane starts at chunk f0 < 16 of its bin's span (ops/csrc/cqcc.cu, design 4)
MIN_LENGTH = 512  # one hop: two frames
MAX_LENGTH = 32_704  # the largest multiple of 64 with T = 1 + n // 512 <= 64 (the shared-memory plan)
COEF_CAP = 2400  # floats of one octave's packed filters the kernel's shared memory holds
# cqcc_launch(y, n_rows, n, coefs, regrid, dct, fir, meta, oct, out, stream)
_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
)


def refusals(y: torch.Tensor, cfg) -> list[str]:
    """Why the kernel cannot compute ``cqcc(y, cfg)``, each reason by name,
    or an empty list: it takes float32 waveforms on the card, under the one
    configuration it is built for (``CQCCConfig()``: sr 16000, hop 512, 84
    bins from C1, 12 an octave, filter_scale 1, 19 cepstra, the 63-tap FIR),
    of a length that is a multiple of 64 in [512, 32704], and no backward
    (autograd would need one when grad mode is on and ``y`` requires grad)."""
    why = []
    if not y.is_cuda:
        why.append("device")
    if y.dtype != torch.float32:
        why.append("dtype")
    if cfg.cqt != CQTConfig() or cfg.n_ceps != N_CEPS or _NUMTAPS != 63:
        why.append("config")
    n = y.shape[-1] if y.dim() else 0
    if n % 64 or not MIN_LENGTH <= n <= MAX_LENGTH:
        why.append("length")
    if torch.is_grad_enabled() and y.requires_grad:
        why.append("grad")
    return why


def takes(y: torch.Tensor, cfg) -> bool:
    """Whether ``cqcc()`` computes ``y`` through the kernel."""
    return not refusals(y, cfg)


@lru_cache(maxsize=None)
def host_tables(cfg) -> dict[str, np.ndarray]:
    """The kernel's tables for ``cfg`` (a ``CQCCConfig``), from the plain
    path's host operators:

    - ``coefs``: float32, per octave (from the top) the real rows of its 12
      bins, then their imaginary rows; bin i's row holds the bank's taps over
      ``[a_lo, a_lo + 4 nc)`` about the frame centre, the bin's nonzero span
      widened to whole 4-tap chunks (the widening holds zeros);
    - ``meta``: int32 ``(3, 7, 12)``: ``a_lo``, ``nc`` and the row's offset
      in its octave's table; ``oct``: int32 ``(2, 7)``: each octave's table
      offset in ``coefs`` and its length;
    - ``fir``: the 63 float32 half-band taps;
    - ``regrid``: float64 ``(84, 4)``: each row's first column, its two
      weights and 0;
    - ``dct``: float64 ``(19, 84)``, the orthonormal DCT-II rows.
    """
    from audioanalysisdetector_tpu_torch.frontend.cqcc import _linear_regrid_matrix

    cq = cfg.cqt
    meta = np.zeros((3, OCTAVES, BINS), np.int32)
    octs = np.zeros((2, OCTAVES), np.int32)
    tables = []
    for j in range(OCTAVES):
        kernels, K = _octave_kernel_bank(cq, j)
        bank = kernels[:, 0, :]
        re_rows, im_rows, off = [], [], 0
        for i in range(BINS):
            nz = np.flatnonzero((bank[i] != 0) | (bank[BINS + i] != 0))
            a_lo = int(nz[0]) - K // 2
            a_lo -= a_lo % CHUNK
            nc = -(-(int(nz[-1]) + 1 - K // 2 - a_lo) // CHUNK)
            cols = slice(K // 2 + a_lo, K // 2 + a_lo + CHUNK * nc)
            re_rows.append(bank[i, cols])
            im_rows.append(bank[BINS + i, cols])
            meta[:, j, i] = a_lo, nc, off
            off += CHUNK * nc
        table = np.concatenate(re_rows + im_rows)
        octs[:, j] = sum(len(t) for t in tables), len(table)
        tables.append(table)
    if meta[1].min() < MIN_PHASES or octs[1].max() > COEF_CAP:
        raise ValueError("the octave banks do not fit the kernel's chunk plan")
    W = _linear_regrid_matrix(cq.n_bins, cq.fmin, cq.bins_per_octave)
    idx = np.minimum(np.argmax(W != 0, axis=1), cq.n_bins - 2)
    rows = np.arange(cq.n_bins)
    regrid = np.stack([idx, W[rows, idx], W[rows, idx + 1], np.zeros(cq.n_bins)], axis=1)
    return {
        "coefs": np.concatenate(tables).astype(np.float32),
        "meta": meta,
        "oct": octs,
        "fir": np.ascontiguousarray(_halfband_fir(_NUMTAPS), np.float32),
        "regrid": regrid,
        "dct": dct_ii_matrix(cq.n_bins, cfg.n_ceps),
    }


@lru_cache(maxsize=None)
def _device_tables(cfg, device: torch.device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``coefs``, ``regrid`` and ``dct`` on ``device`` in float32."""
    t = host_tables(cfg)
    return tuple(torch.from_numpy(np.ascontiguousarray(t[k])).to(device, torch.float32)
                 for k in ("coefs", "regrid", "dct"))


def cqcc_kernel(y: torch.Tensor, cfg) -> torch.Tensor:
    """``(..., n)`` float32 waveforms on the card -> ``(..., 19, 1 + n //
    512)`` CQCC, one launch of the kernel on the current stream, counted as
    ``cqcc``. Call it where ``takes(y, cfg)`` holds."""
    if not on_card(y, "cqcc"):
        raise ValueError("the CQCC kernel runs on the card: cqcc() computes a CPU tensor")
    why = [r for r in refusals(y, cfg) if r not in ("device", "grad")]  # launch raises on grad
    if why:
        raise ValueError(f"the CQCC kernel cannot take this input: {', '.join(why)}")
    lead, n = y.shape[:-1], y.shape[-1]
    rows = y.reshape(-1, n)
    if not rows.is_contiguous() or rows.data_ptr() % 16:
        rows = rows.clone(memory_format=torch.contiguous_format)
    n_rows, n_frames = rows.shape[0], 1 + n // cfg.cqt.hop_length
    out = rows.new_empty((n_rows, N_CEPS, n_frames))
    coefs, regrid, dct = _device_tables(cfg, rows.device)
    host = host_tables(cfg)
    if not n_rows:
        return out.reshape(*lead, N_CEPS, n_frames)
    with span("cqcc.kernel"):
        launch(
            _build.entry_point("cqcc", "cqcc_launch", _ARGTYPES), rows, "cqcc",
            rows.data_ptr(), n_rows, n, coefs.data_ptr(), regrid.data_ptr(), dct.data_ptr(),
            host["fir"].ctypes.data, host["meta"].ctypes.data, host["oct"].ctypes.data, out.data_ptr(),
            rows=n_rows,
        )
    return out.reshape(*lead, N_CEPS, n_frames)
