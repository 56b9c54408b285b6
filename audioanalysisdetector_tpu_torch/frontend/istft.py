"""Inverse STFT (overlap-add), matmul-based — supports the phase vocoder (PyTorch).

Counterpart of the JAX package's ``frontend/istft.py``. It matches the
forward conventions in ``stft.py``: periodic Hann, centered frames. The
inverse real DFT of each frame is a GEMM against host-built cos/sin bases
(``_irdft_bases``, a copy of the JAX package's). The frames overlap-add
through ``torch.nn.functional.fold``, which sums each output sample over the
frames that cover it: no scatter, so no atomics and the same sum on every
run. The squared-window normalisation is a host constant, as in JAX.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from audioanalysisdetector_tpu_torch.frontend.stft import _window_array


@lru_cache(maxsize=None)
def _irdft_bases(n_fft: int) -> tuple[np.ndarray, np.ndarray]:
    """Bases s.t. ``frame = Re @ C.T + Im @ S.T`` for an rDFT of size n_fft."""
    k = np.arange(n_fft // 2 + 1)[None, :]
    n = np.arange(n_fft)[:, None]
    ang = 2.0 * np.pi * n * k / n_fft
    scale = np.full(n_fft // 2 + 1, 2.0)
    scale[0] = 1.0
    if n_fft % 2 == 0:
        scale[-1] = 1.0
    C = (np.cos(ang) * scale[None, :] / n_fft).astype(np.float32)  # (n_fft, F)
    S = (-np.sin(ang) * scale[None, :] / n_fft).astype(np.float32)
    return C, S


@lru_cache(maxsize=None)
def _window_norm(n_fft: int, hop_length: int, n_frames: int, window: str) -> np.ndarray:
    """1 / the summed squared window at each output sample (floored at 1e-8)."""
    w = _window_array(window, n_fft, n_fft).astype(np.float32)
    out_len = n_fft + (n_frames - 1) * hop_length
    norm = np.zeros(out_len, dtype=np.float32)
    idx = np.arange(n_frames)[:, None] * hop_length + np.arange(n_fft)[None, :]
    np.add.at(norm, idx, (w * w)[None, :])
    return np.maximum(norm, 1e-8)


@lru_cache(maxsize=None)
def _istft_operands_on(n_fft: int, window: str, device: torch.device) -> tuple[torch.Tensor, ...]:
    C, S = _irdft_bases(n_fft)
    w = _window_array(window, n_fft, n_fft).astype(np.float32)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in (C.T, S.T, w))


def istft(
    spec_re: torch.Tensor,
    spec_im: torch.Tensor,
    *,
    n_fft: int = 2048,
    hop_length: int = 512,
    window: str = "hann",
    length: int | None = None,
) -> torch.Tensor:
    """Inverse STFT of ``(..., F, T)`` re/im parts -> ``(..., n)`` waveforms.

    Windowed overlap-add with squared-window normalization (librosa/torch
    semantics); assumes the forward used ``center=True``.
    """
    CT, ST, w = _istft_operands_on(n_fft, window, spec_re.device)
    frames = spec_re.transpose(-1, -2) @ CT + spec_im.transpose(-1, -2) @ ST  # (..., T, n_fft)
    frames = frames * w
    lead, T = frames.shape[:-2], frames.shape[-2]
    out_len = n_fft + (T - 1) * hop_length
    cols = frames.reshape(-1, T, n_fft).transpose(1, 2)  # (N, n_fft, T): fold's columns
    sig = F.fold(cols, output_size=(1, out_len), kernel_size=(1, n_fft), stride=(1, hop_length))
    norm = torch.from_numpy(_window_norm(n_fft, hop_length, T, window)).to(sig.device)
    sig = (sig.reshape(*lead, out_len) / norm)[..., n_fft // 2 :]  # undo center padding
    if length is None:
        return sig[..., : out_len - n_fft]
    sig = sig[..., :length]
    if length > sig.shape[-1]:
        sig = F.pad(sig, (0, length - sig.shape[-1]))
    return sig
