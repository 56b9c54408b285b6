"""Mel power straight from raw waveforms: the hand-written Hopper kernel.

Counterpart of the JAX package's ``ops/wave_mel.py::wave_mel``
(wrapper ``wave_log_mel``): center-padded waveforms ``(B, n_pad)`` -> mel
power ``(B, n_frames, n_mels)``. Frame rows are read straight from the
padded waveform at ``u * n_pad + f * hop``, so no frame matrix ever exists
in device memory; the windowed-DFT products, |X|^2 and the mel projection
all happen on chip, the products on the tensor cores with float32 operands
split into three bf16 parts. The CUDA source is ``ops/csrc/wave_mel.cu`` (design and bounds in
its header note); ``_kernel_operands`` builds the operands it reads.

It takes every mel configuration the JAX chain computes: any ``power``
(|X|^2 raised to ``power / 2`` per bin before the mel step), any
``n_mels`` (filters in groups of at most 128 columns, one grid row each,
each group recomputing the DFT of its rows) and float32 or bfloat16
waveforms (bf16: the hi-only bases, one product per step, fp32 sums, as
K2's bf16 frames). The result is float32 for both, the dtype the JAX chain
returns for a bf16 waveform (its bf16 frames promote against f32 bases).

``wave_mel`` launches the kernel on a CUDA tensor and runs
``wave_mel_reference``, the plain PyTorch version of the same function, on
a CPU tensor. There is no fallback: a failed build, a missing ``nvcc`` or a
refused launch raises. Unlike the TPU kernel, any batch size is taken (the
ragged last row tile is masked in the kernel).
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from audioanalysisdetector_tpu_torch.frontend.db import power_to_db
from audioanalysisdetector_tpu_torch.frontend.mel import MelConfig
from audioanalysisdetector_tpu_torch.frontend.stft import (
    _rdft_bases,
    center_pad,
    magnitude_power,
    n_frames_for,
)
from audioanalysisdetector_tpu_torch.ops import _build, launch, on_card
from audioanalysisdetector_tpu_torch.utils.profiling import span

K_TILE = 64  # bin padding of the plain version's bases (the JAX kernel's K_TILE)
MAX_MELS = 128  # mel accumulators per row and group (K2 takes one group)
DTYPES = (torch.float32, torch.bfloat16)  # waveform types the kernel takes
N_TILE = 64  # live bins per kernel tile; must equal NB in csrc/wave_mel.cu
K_CHUNK = 32  # samples per kernel stage; must equal KC in csrc/wave_mel.cu
# wave_mel_launch(wav, bases, mel, out, n_rows, n_frames, n_pad, hop, n_fft, n_tiles, n_mels, power, bf16, stream)
_ARGTYPES = (
    (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 2 + (ctypes.c_longlong,) + (ctypes.c_int,) * 4
    + (ctypes.c_float, ctypes.c_int, ctypes.c_void_p)
)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@lru_cache(maxsize=None)
def _operands(cfg: MelConfig, k_pad: int):
    cos_b, sin_b = _rdft_bases(cfg.n_fft, cfg.window, cfg.win_length or cfg.n_fft)
    melT = cfg.filterbank().T.astype(np.float32)
    n_freq = cos_b.shape[1]
    cos_p = np.zeros((cfg.n_fft, k_pad), np.float32)
    sin_p = np.zeros((cfg.n_fft, k_pad), np.float32)
    mel_p = np.zeros((k_pad, melT.shape[1]), np.float32)
    cos_p[:, :n_freq] = cos_b
    sin_p[:, :n_freq] = sin_b
    mel_p[:n_freq] = melT
    return cos_p, sin_p, mel_p


@lru_cache(maxsize=None)
def _operands_on(cfg: MelConfig, device: torch.device) -> tuple[torch.Tensor, ...]:
    """The plain version's float32 bases and mel matrix over every bin,
    uploaded once per (config, device); the kernel reads
    ``_kernel_operands``."""
    k_pad = _round_up(cfg.n_fft // 2 + 1, K_TILE)
    return tuple(torch.from_numpy(a).to(device) for a in _operands(cfg, k_pad))


def live_span(cfg: MelConfig) -> tuple[int, int]:
    """``[k_lo, k_hi)``: the first and one past the last bin whose mel column
    is not all zero. The kernel computes only these bins."""
    nz = np.flatnonzero((cfg.filterbank() != 0).any(axis=0))
    if nz.size == 0:
        return 0, 1
    return int(nz[0]), int(nz[-1]) + 1


def _core_matrices(m: np.ndarray) -> np.ndarray:
    """``(..., N, K)`` -> the wgmma K-major layout without swizzle: 8 x 8
    core matrices (8 N rows of 8 contiguous K values), K-fastest within
    each 8-row group, the groups one after another."""
    *lead, n, k = m.shape
    return m.reshape(*lead, n // 8, 8, k // 8, 8).swapaxes(-3, -2).reshape(*lead, n * k)


def _bf16_parts(a: np.ndarray, n: int) -> torch.Tensor:
    """``a`` as ``n`` bf16 parts, each the rounding of what the ones before
    leave (three hold a float32 exactly), stacked on a new axis before the
    last."""
    rest = torch.from_numpy(np.ascontiguousarray(a))
    parts = []
    for _ in range(n):
        parts.append(rest.to(torch.bfloat16))
        rest = rest - parts[-1].float()
    return torch.stack(parts, dim=-2)


def _mel_cols(n_mels: int) -> int:
    """Mel accumulator columns of a group: 64 up to 64 mels, else 128
    (csrc/wave_mel.cu's MC)."""
    return 64 if n_mels <= 64 else MAX_MELS


def mel_groups(n_mels: int) -> int:
    """Groups of ``_mel_cols`` filters the kernel's grid rows take."""
    return -(-n_mels // _mel_cols(n_mels))


@lru_cache(maxsize=None)
def _kernel_operands(
    cfg: MelConfig, device: torch.device, split: bool = True
) -> tuple[torch.Tensor, torch.Tensor, int]:
    """The kernel's operands, once per (config, device, split):
    ``(bases, mel, n_tiles)``.

    The live span is cut into ``n_tiles`` tiles of ``N_TILE`` bins (bins
    past the spectrum are zero). ``bases`` is ``(n_tiles, n_chunks, parts,
    2 * N_TILE * K_CHUNK)`` bf16: for each tile and chunk of ``K_CHUNK``
    samples, the windowed cos and sin columns of the tile's bins side by
    side (128 columns), transposed to K-major core matrices, in three bf16
    parts that sum to the float32 basis exactly (with ``split``; the first
    part alone otherwise). ``mel`` is ``(n_groups * n_tiles, N_TILE * cols
    + cols)`` float32 with ``cols = _mel_cols(n_mels)``, row ``g * n_tiles +
    t`` the block of filters ``[cols g, cols g + cols)`` on tile ``t``: the
    filterbank over the tile's bins ``(N_TILE, cols)``, then for each filter
    the tile-local ``[lo, hi)`` of its nonzero bins packed as the uint32
    ``lo | hi << 16`` (bit-cast; empty for the padding columns)."""
    cos_b, sin_b = _rdft_bases(cfg.n_fft, cfg.window, cfg.win_length or cfg.n_fft)
    n_freq = cos_b.shape[1]
    k_lo, k_hi = live_span(cfg)
    n_tiles = -(-(k_hi - k_lo) // N_TILE)
    n_chunks = -(-cfg.n_fft // K_CHUNK)
    bins = k_lo + np.arange(n_tiles * N_TILE)
    live = bins < n_freq
    cs = np.zeros((2, n_chunks * K_CHUNK, n_tiles * N_TILE), np.float32)
    cs[0][: cfg.n_fft, live] = cos_b[:, bins[live]]
    cs[1][: cfg.n_fft, live] = sin_b[:, bins[live]]
    # (cos/sin, chunk, k, tile, bin) -> (tile, chunk, [cos bins | sin bins], k)
    b = cs.reshape(2, n_chunks, K_CHUNK, n_tiles, N_TILE).transpose(3, 1, 0, 4, 2)
    b = _core_matrices(b.reshape(n_tiles, n_chunks, 2 * N_TILE, K_CHUNK))

    cols, n_groups = _mel_cols(cfg.n_mels), mel_groups(cfg.n_mels)
    fbT = np.zeros((n_tiles * N_TILE, n_groups * cols), np.float32)
    fbT[live, : cfg.n_mels] = cfg.filterbank().T[bins[live]]
    # (bin, group, filter) -> (group, tile, bin, filter)
    weights = fbT.reshape(n_tiles, N_TILE, n_groups, cols).transpose(2, 0, 1, 3)
    nz = weights != 0
    any_nz = nz.any(axis=2)  # (group, tile, filter)
    lo = np.where(any_nz, nz.argmax(axis=2), 0)
    hi = np.where(any_nz, N_TILE - nz[:, :, ::-1].argmax(axis=2), 0)
    rows = n_groups * n_tiles
    mel = np.concatenate(
        [weights.reshape(rows, -1), (lo | hi << 16).astype(np.uint32).reshape(rows, cols).view(np.float32)],
        axis=1,
    )
    return _bf16_parts(b, 3 if split else 1).to(device), torch.from_numpy(mel).to(device), n_tiles


def _check(wav_padded: torch.Tensor, cfg: MelConfig, n_frames: int) -> None:
    if wav_padded.dim() != 2:
        raise ValueError(f"expected (B, n_padded) waveforms, got {tuple(wav_padded.shape)}")
    if wav_padded.dtype not in DTYPES:
        raise NotImplementedError(f"wave_mel takes float32 or bfloat16, got {wav_padded.dtype}")
    if not wav_padded.is_contiguous():
        raise ValueError("wave_mel needs a contiguous waveform tensor")
    if n_frames < 1 or (n_frames - 1) * cfg.hop_length + cfg.n_fft > wav_padded.shape[1]:
        # the kernel reads frame rows unchecked: an oversized n_frames would
        # read past each utterance into the next one
        raise ValueError("padded signal too short for n_frames")


def wave_mel_reference(
    wav_padded: torch.Tensor, cfg: MelConfig = MelConfig(), *, n_frames: int
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: frames via ``unfold``, the two
    DFT matmuls, |X|^power and the mel matmul -> ``(B, n_frames, n_mels)``
    float32. A bf16 waveform meets bf16-rounded bases with fp32 sums."""
    _check(wav_padded, cfg, n_frames)
    cos_p, sin_p, mel_p = _operands_on(cfg, wav_padded.device)
    frames = wav_padded.unfold(-1, cfg.n_fft, cfg.hop_length)[:, :n_frames]
    if wav_padded.dtype == torch.bfloat16:
        frames = frames.float()
        cos_p, sin_p = (b.to(torch.bfloat16).float() for b in (cos_p, sin_p))
    re = frames @ cos_p
    im = frames @ sin_p
    return magnitude_power(re * re + im * im, cfg.power) @ mel_p


def wave_mel(
    wav_padded: torch.Tensor, cfg: MelConfig = MelConfig(), *, n_frames: int
) -> torch.Tensor:
    """(B, n_padded) center-padded waveforms -> (B, n_frames, n_mels) mel.

    ``wav_padded`` must already carry the center padding (n_fft//2 each
    side, reflect). On a CUDA tensor this launches the kernel on the current
    stream; on a CPU tensor it is ``wave_mel_reference``.
    """
    _check(wav_padded, cfg, n_frames)
    if not on_card(wav_padded, "wave_mel"):
        return wave_mel_reference(wav_padded, cfg, n_frames=n_frames)
    B, n_pad = wav_padded.shape
    bf16 = wav_padded.dtype == torch.bfloat16
    bases, mel, n_tiles = _kernel_operands(cfg, wav_padded.device, split=not bf16)
    out = torch.empty((B, n_frames, cfg.n_mels), dtype=torch.float32, device=wav_padded.device)
    launch(
        _build.entry_point("wave_mel", "wave_mel_launch", _ARGTYPES), wav_padded, "wave_mel",
        wav_padded.data_ptr(), bases.data_ptr(), mel.data_ptr(), out.data_ptr(), B * n_frames, n_frames, n_pad,
        cfg.hop_length, cfg.n_fft, n_tiles, cfg.n_mels, float(cfg.power), int(bf16),
        rows=B * n_frames,
    )
    return out


def wave_mel_unpadded(y: torch.Tensor, cfg: MelConfig) -> torch.Tensor:
    """``(..., n)`` raw waveforms -> ``(..., T, n_mels)`` through ``wave_mel``,
    applying ``cfg.center`` / ``cfg.pad_mode`` first (``melspectrogram``'s
    CUDA route)."""
    lead, n = y.shape[:-1], y.shape[-1]
    n_frames = n_frames_for(n, cfg.hop_length, cfg.n_fft, cfg.center)
    flat = y.reshape(-1, n)
    if cfg.center:
        with span("mel.pad"):
            flat = center_pad(flat, cfg.n_fft, cfg.pad_mode)
    mel = wave_mel(flat.contiguous(), cfg, n_frames=n_frames)
    return mel.reshape(*lead, n_frames, cfg.n_mels)


def wave_log_mel(
    wav: torch.Tensor,
    cfg: MelConfig = MelConfig(),
    *,
    ref="max",
    top_db: float | None = 80.0,
) -> torch.Tensor:
    """Drop-in (B, n) -> (B, n_mels, T) using the wave-direct kernel."""
    mel = wave_mel_unpadded(wav, cfg).transpose(-1, -2)
    return power_to_db(mel, ref=ref, top_db=top_db, utt_axes=2)
