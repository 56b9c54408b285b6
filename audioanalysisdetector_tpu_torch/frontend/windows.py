"""Window functions (host-side, numpy) used to build constant tensors.

Semantics follow librosa's defaults, which take *periodic* ("fftbins=True" in
scipy terms) windows — the convention the reference's extractors inherit via
``librosa.stft`` (reference/ASV_dl_func.py:416, 533).
"""

from __future__ import annotations

import numpy as np


def hann(win_length: int, *, periodic: bool = True) -> np.ndarray:
    """Periodic (DFT-even) Hann window, float64."""
    if win_length == 1:
        return np.ones(1)
    denom = win_length if periodic else win_length - 1
    n = np.arange(win_length)
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * n / denom)


def hamming(win_length: int, *, periodic: bool = True) -> np.ndarray:
    """Periodic Hamming window (spafe's frame window default), float64."""
    if win_length == 1:
        return np.ones(1)
    denom = win_length if periodic else win_length - 1
    n = np.arange(win_length)
    return 0.54 - 0.46 * np.cos(2.0 * np.pi * n / denom)


_WINDOWS = {"hann": hann, "hamming": hamming}


def get_window(name: str, win_length: int, *, periodic: bool = True) -> np.ndarray:
    if name not in _WINDOWS:
        raise ValueError(f"unknown window {name!r}; available: {sorted(_WINDOWS)}")
    return _WINDOWS[name](win_length, periodic=periodic)


def pad_center(window: np.ndarray, size: int) -> np.ndarray:
    """Center-pad a window to ``size`` samples (librosa ``util.pad_center``)."""
    n = len(window)
    if size < n:
        raise ValueError(f"cannot pad window of length {n} to smaller size {size}")
    lpad = (size - n) // 2
    out = np.zeros(size, dtype=window.dtype)
    out[lpad : lpad + n] = window
    return out
