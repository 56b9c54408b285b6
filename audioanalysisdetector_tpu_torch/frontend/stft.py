"""Batched power spectrogram with librosa-parity semantics (PyTorch).

Counterpart of the JAX package's ``frontend/stft.py``. librosa's
conventions, reproduced:

- ``center=True``: the signal is padded by ``n_fft // 2`` on both sides with
  reflection, so frame ``t`` is centered at sample ``t * hop_length``.
- the window is a periodic Hann of ``win_length`` samples, zero-padded
  symmetrically to ``n_fft``.
- output layout is ``(..., n_freqs, n_frames)`` (frequency-major).

Two spectrum paths, as in the JAX package:

- ``method="matmul"``: the DFT as two real matmuls against precomputed
  windowed cos/sin bases (the contract). On a CUDA tensor the mel chain
  routes this through a hand-written kernel instead, ``ops/ct_mel`` or
  ``ops/wave_mel`` (``frontend/mel.py::melspectrogram``);
  ``power_spectrogram`` itself is the plain chain.
- ``method="fft"``: ``torch.fft.rfft`` over the windowed frames.

``stft`` returns the complex STFT (``torch.fft.rfft`` or the two GEMMs);
``stft_realimag`` returns the matmul DFT as separate real and imaginary
parts, which the phase vocoder (``data/augment.py``) reads its phases from.
The JAX package's ``method="block"`` (hop-block DFT decomposition) was
measured and rejected there and is not ported.

The numpy builders (``n_frames_for``, ``_window_array``, ``_rdft_bases``)
are copies of the JAX package's, so both packages use bitwise-equal
constants.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from audioanalysisdetector_tpu_torch.frontend.windows import get_window, pad_center


def n_frames_for(n_samples: int, hop_length: int, n_fft: int, center: bool) -> int:
    """Number of STFT frames for a signal of static length ``n_samples``.

    Exactly ``frame_signal``'s count — for odd ``n_fft`` the center padding
    is ``2 * (n_fft // 2) = n_fft - 1``, so the popular ``1 + n // hop``
    shortcut is one off there."""
    padded = n_samples + 2 * (n_fft // 2) if center else n_samples
    if padded < n_fft:
        raise ValueError(
            f"signal of {n_samples} samples is shorter than one {n_fft}-point "
            f"frame (center={center})"
        )
    return 1 + (padded - n_fft) // hop_length


@lru_cache(maxsize=None)
def _window_array(window: str, win_length: int, n_fft: int) -> np.ndarray:
    return pad_center(get_window(window, win_length, periodic=True), n_fft)


@lru_cache(maxsize=None)
def _rdft_bases(n_fft: int, window: str, win_length: int) -> tuple[np.ndarray, np.ndarray]:
    """Windowed real-DFT cos/sin bases, each ``(n_fft, n_fft // 2 + 1)`` f32."""
    w = _window_array(window, win_length, n_fft)
    n = np.arange(n_fft)[:, None]
    k = np.arange(n_fft // 2 + 1)[None, :]
    ang = 2.0 * np.pi * n * k / n_fft
    cos_b = (np.cos(ang) * w[:, None]).astype(np.float32)
    sin_b = (-np.sin(ang) * w[:, None]).astype(np.float32)
    return cos_b, sin_b


@lru_cache(maxsize=None)
def _rdft_bases_on(
    n_fft: int, window: str, win_length: int, device: torch.device
) -> tuple[torch.Tensor, torch.Tensor]:
    """``_rdft_bases`` uploaded once per device (constants, never mutated)."""
    return tuple(
        torch.from_numpy(b).to(device) for b in _rdft_bases(n_fft, window, win_length)
    )


def center_pad(y: torch.Tensor, n_fft: int, pad_mode: str = "reflect") -> torch.Tensor:
    """Pad the last axis by ``n_fft // 2`` on both sides (librosa ``center``)."""
    pad = n_fft // 2
    lead = y.shape[:-1]
    flat = y.reshape(-1, 1, y.shape[-1])  # F.pad's reflect mode wants (N, C, L)
    return F.pad(flat, (pad, pad), mode=pad_mode).reshape(*lead, -1)


def frame_signal(
    y: torch.Tensor,
    *,
    n_fft: int,
    hop_length: int,
    center: bool = True,
    pad_mode: str = "reflect",
) -> torch.Tensor:
    """Slice ``(..., n)`` waveforms into ``(..., n_frames, n_fft)`` frames.

    The frames are a strided view (``unfold``) of the padded signal."""
    if center:
        y = center_pad(y, n_fft, pad_mode)
    n = y.shape[-1]
    if n < n_fft:
        raise ValueError(
            f"signal of {n} samples (after padding) is shorter than one "
            f"{n_fft}-point frame"
        )
    return y.unfold(-1, n_fft, hop_length)


def magnitude_power(mag2: torch.Tensor, power: float) -> torch.Tensor:
    """|X|^2 -> |X|^power: as it is at 2, its root at 1, else ``** (power / 2)``."""
    if power == 2.0:
        return mag2
    if power == 1.0:
        return torch.sqrt(mag2)
    return mag2 ** (power / 2.0)


def power_spectrogram(
    y: torch.Tensor,
    *,
    n_fft: int = 2048,
    hop_length: int = 512,
    win_length: int | None = None,
    window: str = "hann",
    center: bool = True,
    pad_mode: str = "reflect",
    power: float = 2.0,
    method: str = "matmul",
) -> torch.Tensor:
    """|STFT|**power of ``(..., n)`` signals -> ``(..., n_fft//2+1, n_frames)``.

    The matmul method never materializes a complex tensor: frames @ cos/sin
    bases, square, add. A bfloat16 signal meets the float32 bases in float32,
    as the JAX package's promotion does."""
    win_length = n_fft if win_length is None else win_length
    frames = frame_signal(
        y, n_fft=n_fft, hop_length=hop_length, center=center, pad_mode=pad_mode
    )
    if method == "matmul":
        cos_b, sin_b = _rdft_bases_on(n_fft, window, win_length, frames.device)
        dtype = torch.promote_types(frames.dtype, cos_b.dtype)
        frames, cos_b, sin_b = frames.to(dtype), cos_b.to(dtype), sin_b.to(dtype)
        re = frames @ cos_b
        im = frames @ sin_b
        mag2 = re * re + im * im
    elif method == "fft":
        w = torch.from_numpy(_window_array(window, win_length, n_fft))
        spec = torch.fft.rfft(frames * w.to(frames.device, frames.dtype), dim=-1)
        mag2 = spec.real**2 + spec.imag**2
    else:
        raise ValueError(f"unknown stft method {method!r}")
    return magnitude_power(mag2, power).transpose(-1, -2)


def stft(
    y: torch.Tensor,
    *,
    n_fft: int = 2048,
    hop_length: int = 512,
    win_length: int | None = None,
    window: str = "hann",
    center: bool = True,
    pad_mode: str = "reflect",
    method: str = "fft",
) -> torch.Tensor:
    """Complex STFT of ``(..., n)`` signals -> ``(..., n_fft//2+1, n_frames)``."""
    win_length = n_fft if win_length is None else win_length
    if method == "fft":
        frames = frame_signal(y, n_fft=n_fft, hop_length=hop_length, center=center, pad_mode=pad_mode)
        w = torch.from_numpy(_window_array(window, win_length, n_fft)).to(frames.device, frames.dtype)
        spec = torch.fft.rfft(frames * w, dim=-1)
    elif method == "matmul":
        re, im = stft_realimag(
            y, n_fft=n_fft, hop_length=hop_length, win_length=win_length, window=window,
            center=center, pad_mode=pad_mode,
        )
        return torch.complex(re, im)
    else:
        raise ValueError(f"unknown stft method {method!r}")
    return spec.transpose(-1, -2)


def stft_realimag(
    y: torch.Tensor,
    *,
    n_fft: int = 2048,
    hop_length: int = 512,
    win_length: int | None = None,
    window: str = "hann",
    center: bool = True,
    pad_mode: str = "reflect",
) -> tuple[torch.Tensor, torch.Tensor]:
    """STFT as separate (re, im) real tensors, each ``(..., F, T)``: the
    frames against the windowed cos/sin bases, two GEMMs, no complex dtype."""
    win_length = n_fft if win_length is None else win_length
    frames = frame_signal(y, n_fft=n_fft, hop_length=hop_length, center=center, pad_mode=pad_mode)
    cos_b, sin_b = _rdft_bases_on(n_fft, window, win_length, frames.device)
    re = frames @ cos_b.to(frames.dtype)
    im = frames @ sin_b.to(frames.dtype)
    return re.transpose(-1, -2), im.transpose(-1, -2)
