"""Plain building blocks of the references: windows, the Slaney mel
filterbank, decibels, an LSTM written out step by step, and the precision
switch. Plain PyTorch and numpy; nothing here imports the port.

Every function computes in the dtype of its input, so one reference serves
at float64 (the yardstick that ``correct`` is judged against) and at
float32 with TF32 on (the control, ``precision(tf32=True)``).
"""

from __future__ import annotations

import contextlib
import math
from functools import lru_cache

import numpy as np
import torch


@contextlib.contextmanager
def precision(*, tf32: bool):
    """TF32 in matrix products and cuDNN on or off inside the block, as it
    was after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def hann(n: int, *, periodic: bool) -> np.ndarray:
    """Hann window: periodic (an STFT's) or symmetric (a CQT filter's)."""
    denom = n if periodic else n - 1
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / denom)


def _hz_to_mel(f: np.ndarray) -> np.ndarray:
    """Slaney's mel scale: linear below 1 kHz, logarithmic above."""
    f = np.asarray(f, dtype=np.float64)
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    logstep = math.log(6.4) / 27.0
    return np.where(f >= min_log_hz, min_log_hz / f_sp + np.log(np.maximum(f, min_log_hz) / min_log_hz) / logstep,
                    f / f_sp)


def _mel_to_hz(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = math.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), f_sp * m)


@lru_cache(maxsize=None)
def mel_filterbank(sr: int, n_fft: int, n_mels: int) -> np.ndarray:
    """librosa's ``filters.mel(sr, n_fft, n_mels)`` defaults: Slaney scale,
    fmin 0, fmax sr/2, triangles normalised to unit area; ``(n_mels,
    n_fft // 2 + 1)`` float64, read-only."""
    fft_f = np.linspace(0.0, sr / 2.0, n_fft // 2 + 1)
    mel_f = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(sr / 2.0), n_mels + 2))
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fft_f[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    w = np.maximum(0.0, np.minimum(lower, upper)) * (2.0 / (mel_f[2:] - mel_f[:-2]))[:, None]
    w.flags.writeable = False
    return w


def power_to_db(s: torch.Tensor, *, amin: float, top_db: float) -> torch.Tensor:
    """``10 log10(S / max S)`` per utterance (the last two axes), floored at
    ``amin`` and clipped ``top_db`` below the utterance's peak."""
    ref = torch.amax(s, dim=(-2, -1), keepdim=True)
    db = 10.0 * torch.log10(torch.clamp(s, min=amin)) - 10.0 * torch.log10(torch.clamp(ref, min=amin))
    return torch.maximum(db, torch.amax(db, dim=(-2, -1), keepdim=True) - top_db)


def lstm(x: torch.Tensor, w_ih: torch.Tensor, w_hh: torch.Tensor, b_ih: torch.Tensor, b_hh: torch.Tensor,
         *, reverse: bool = False, steps: int | None = None) -> torch.Tensor:
    """One LSTM direction over ``x`` ``(B, T, I)`` from a zero state, gates
    ``[i, f, g, o]``: ``(B, T, H)`` outputs in time order. ``reverse`` runs
    from the last frame back; ``steps`` stops after that many steps (the
    rest of the output stays 0)."""
    b, t, _ = x.shape
    hdim = w_hh.shape[1]
    xw = x @ w_ih.T + (b_ih + b_hh)
    h = x.new_zeros(b, hdim)
    c = x.new_zeros(b, hdim)
    out = x.new_zeros(b, t, hdim)
    order = range(t - 1, -1, -1) if reverse else range(t)
    for n, k in enumerate(order):
        if steps is not None and n >= steps:
            break
        gates = xw[:, k] + h @ w_hh.T
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        out[:, k] = h
    return out


def in_blocks(fn, x: torch.Tensor, rows: int) -> torch.Tensor:
    """``fn`` over ``x`` in blocks of ``rows`` rows, concatenated: the
    reference fits beside the program's memory at any batch."""
    return torch.cat([fn(x[i:i + rows]) for i in range(0, x.shape[0], rows)])
