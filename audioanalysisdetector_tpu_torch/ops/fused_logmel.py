"""Mel power from frames gathered beforehand: the hand-written Hopper kernel (K2).

Counterpart of the JAX package's ``ops/fused_logmel.py``
(``fused_mel_from_frames``, drop-in ``fused_log_mel_spectrogram``): frames
``(N, n_fft)`` -> mel power ``(N, n_mels)``, the windowed DFT, ``|X|^2`` and
the mel projection fused so that no spectrum exists in device memory. With
``compute_dtype="bfloat16"`` the frames and the DFT bases are rounded to
bf16 and every product and sum stays fp32; the mel matrix stays fp32.

The kernel is K1's CUDA core (``ops/csrc/wave_mel.cu``) through its second
entry point ``frames_mel_launch``: a frame matrix is K1's row addressing
with one frame per row, and the core is templated on the frame element
type: float32 frames take K1's three-part bf16 bases (six tensor-core
products), bfloat16 frames the first parts alone (one product, exactly this
function's bf16 semantics). ``fused_mel_from_frames`` launches it on a CUDA
tensor and runs ``fused_mel_from_frames_reference``, the plain PyTorch
version, on a CPU tensor. There is no fallback.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from audioanalysisdetector_tpu_torch.frontend.db import power_to_db
from audioanalysisdetector_tpu_torch.frontend.mel import MelConfig
from audioanalysisdetector_tpu_torch.frontend.stft import frame_signal
from audioanalysisdetector_tpu_torch.ops import _build, refuse_grad
from audioanalysisdetector_tpu_torch.ops.wave_mel import MAX_MELS, _kernel_operands, _operands_on

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# Kernel launches made by ``fused_mel_from_frames`` in this process. Only the
# wrapper's CUDA branch adds to it, one per launch.
launches = 0


@lru_cache(maxsize=None)
def _bases_on(cfg: MelConfig, device: torch.device, dtype: torch.dtype) -> tuple[torch.Tensor, ...]:
    """K1's padded cos/sin bases in ``dtype`` and its f32 mel matrix."""
    cos_p, sin_p, mel_p = _operands_on(cfg, device)
    return cos_p.to(dtype), sin_p.to(dtype), mel_p


@lru_cache(maxsize=None)
def _kernel():
    fn = _build.load_library("wave_mel").frames_mel_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(frames: torch.Tensor, cfg: MelConfig, compute_dtype: str) -> torch.dtype:
    if compute_dtype not in DTYPES:
        raise ValueError(f"compute_dtype must be one of {sorted(DTYPES)}, got {compute_dtype!r}")
    if frames.dim() != 2 or frames.shape[1] != cfg.n_fft:
        raise ValueError(f"expected (N, {cfg.n_fft}) frames, got {tuple(frames.shape)}")
    if not frames.is_floating_point():
        raise NotImplementedError(f"fused_mel_from_frames takes float frames, got {frames.dtype}")
    if cfg.n_mels > MAX_MELS:
        raise NotImplementedError(f"the kernel takes at most {MAX_MELS} mels, got {cfg.n_mels}")
    return DTYPES[compute_dtype]


def fused_mel_from_frames_reference(
    frames: torch.Tensor, cfg: MelConfig = MelConfig(), *, compute_dtype: str = "float32"
) -> torch.Tensor:
    """Plain PyTorch version: frames and bases rounded to ``compute_dtype``
    and widened back, then the two DFT matmuls, ``|X|^2`` and the mel
    matmul in f32 -> ``(N, n_mels)``."""
    dtype = _check(frames, cfg, compute_dtype)
    cos_b, sin_b, mel_p = _bases_on(cfg, frames.device, dtype)
    f = frames.to(dtype).float()
    re = f @ cos_b.float()
    im = f @ sin_b.float()
    return (re * re + im * im) @ mel_p


def fused_mel_from_frames(
    frames: torch.Tensor, cfg: MelConfig = MelConfig(), *, compute_dtype: str = "float32"
) -> torch.Tensor:
    """(N, n_fft) frames (window not applied) -> (N, n_mels) mel power.

    The window is folded into the DFT bases, so raw frames go straight in.
    On a CUDA tensor this launches the kernel on the current stream (the
    frames are cast to ``compute_dtype`` first); on a CPU tensor it is
    ``fused_mel_from_frames_reference``. Any N is taken.
    """
    global launches
    dtype = _check(frames, cfg, compute_dtype)
    if not frames.is_cuda:
        if frames.device.type != "cpu":
            raise NotImplementedError(f"fused_mel_from_frames has no path for {frames.device}")
        return fused_mel_from_frames_reference(frames, cfg, compute_dtype=compute_dtype)
    refuse_grad(frames, "fused_mel_from_frames")
    n = frames.shape[0]
    if n >= 2**31:
        raise ValueError(f"{n} frame rows overflow the kernel's int row index")
    x = frames.to(dtype).contiguous()
    if dtype == torch.bfloat16 and (x.data_ptr() % 16 or cfg.n_fft % 8):
        # bf16 rows are staged in 16-byte copies: a fresh (aligned) copy,
        # rows zero-extended to a multiple of 8 elements
        aligned = x.new_zeros((n, -(-cfg.n_fft // 8) * 8))
        aligned[:, : cfg.n_fft] = x
        x = aligned
    bases, mel, n_tiles = _kernel_operands(cfg, frames.device, dtype == torch.float32)
    out = torch.empty((n, cfg.n_mels), dtype=torch.float32, device=frames.device)
    fn = _kernel()
    with torch.cuda.device(frames.device):
        rc = fn(
            x.data_ptr(),
            bases.data_ptr(),
            mel.data_ptr(),
            out.data_ptr(),
            n,
            x.shape[1],
            cfg.n_fft,
            n_tiles,
            cfg.n_mels,
            int(dtype == torch.bfloat16),
            torch.cuda.current_stream(frames.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"fused_mel_from_frames kernel launch failed with CUDA error {rc}")
    launches += 1
    return out


def fused_log_mel_spectrogram(
    y: torch.Tensor,
    cfg: MelConfig = MelConfig(),
    *,
    ref: float | str = "max",
    top_db: float | None = 80.0,
    compute_dtype: str = "float32",
) -> torch.Tensor:
    """Drop-in fused replacement for ``frontend.log_mel_spectrogram``:
    ``(..., n) -> (..., n_mels, T)`` with per-utterance dB reference. The
    frames are gathered into an ``(N, n_fft)`` matrix first."""
    frames = frame_signal(
        y, n_fft=cfg.n_fft, hop_length=cfg.hop_length, center=cfg.center,
        pad_mode=cfg.pad_mode,
    )  # (..., T, n_fft)
    lead, T = frames.shape[:-2], frames.shape[-2]
    mel = fused_mel_from_frames(frames.reshape(-1, cfg.n_fft), cfg, compute_dtype=compute_dtype)
    mel = mel.reshape(*lead, T, cfg.n_mels).transpose(-1, -2)  # (..., n_mels, T)
    return power_to_db(mel, ref=ref, top_db=top_db, utt_axes=2)
