"""Mel power of 2048-point frames through a fast Fourier transform: the hand-written Hopper kernel (K3).

Counterpart of the JAX package's ``ops/ct_mel.py`` (``ct_mel``,
``ct_log_mel``; Pallas kernel ``_ct_mel_parts``), which factors the
2048-point DFT as 64 x 32 (``n = n1 + 64 n2``, ``k = k2 + 32 k1``):

    G[k2, n1] = sum_n2 E32[n2, k2] x[n1 + 64 n2]              (stage A)
    X[k2, k1] = sum_n1 G[k2, n1] t[n1, k2] E64[n1, k1]        (twiddle, stage C)

then ``|X|^2`` on bins 0..1024 and the mel projection. ``ct_mel_reference``,
the plain PyTorch version, keeps that factorization as plain matmuls.

The CUDA kernel (``ops/csrc/ct_mel.cu``, design and bound in its header
note) computes the same function as a real FFT, one warp per frame row: the
frame is packed into 1024 complex values, transformed by two passes of
32-point FFTs in registers (a four-step 32 x 32 FFT), and split into the
real frame's bins 0..1024. Its host tables (``_kernel_operands``) are the
twiddles ``W_1024^(a c)`` and ``W_2048^k`` from float64, the window, and the
mel weights laid out for the lanes that sum them. The TPU kernel's lane tricks (the
contraction padded to 128, the packed ``[xr|xi]`` squares and the
duplicated half-weighted mel matrix) are not carried over. Its head/body/tail
reflect split becomes the kernel's frame addressing: a frame starts at
sample ``f * hop - left`` of its row, and the few frames that reach past
either end reflect each sample index themselves. ``ct_mel`` hands it
center-padded rows (``left = 0``, no frame reaches past them);
``ct_mel_unpadded`` hands it the raw waveform (``left = n_fft // 2``), so
on the card librosa's reflect pad writes no padded copy.

``ct_mel`` and ``ct_mel_unpadded`` launch the kernel on a CUDA tensor and run
``ct_mel_reference`` on a CPU tensor (after ``center_pad``). There is no
fallback: a failed build or a refused launch raises. Unlike the TPU kernel,
any batch size is taken.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from audioanalysisdetector_tpu_torch.frontend.db import power_to_db
from audioanalysisdetector_tpu_torch.frontend.mel import MelConfig
from audioanalysisdetector_tpu_torch.frontend.stft import _window_array, center_pad
from audioanalysisdetector_tpu_torch.ops import _build, refuse_grad
from audioanalysisdetector_tpu_torch.utils.profiling import span

N1 = 64  # in-chunk offset / stage-C DFT length
N2 = 32  # chunk index / stage-A DFT length
N_FFT = N1 * N2
LANES = 32  # the FFT kernel's warp: one frame row, 32 x 32 registers

# Kernel launches made by ``ct_mel`` and ``ct_mel_unpadded`` in this
# process, and those of them that read a raw waveform (the reflect pad
# folded in). Only the wrappers' CUDA branches add to them, one per launch.
launches = 0
reflect_launches = 0


def _refusal(cfg: MelConfig, dtype: torch.dtype = torch.float32) -> Exception | None:
    """Why the kernel cannot take a ``dtype`` waveform under ``cfg``, or None.
    The one statement of its constraints: the factorization's shape (the TPU
    kernel's, kept as ``ValueError``), power 2 and float32."""
    if cfg.n_fft != N_FFT:
        return ValueError(f"ct_mel supports n_fft == {N_FFT} only, got {cfg.n_fft}")
    if cfg.hop_length % N1 or cfg.n_fft % cfg.hop_length:
        return ValueError(f"need hop % {N1} == 0 and n_fft % hop == 0, got hop {cfg.hop_length}")
    if dtype != torch.float32:
        return NotImplementedError(f"ct_mel takes float32, got {dtype}")
    if cfg.power != 2.0:
        return NotImplementedError(f"ct_mel computes power 2 only, got {cfg.power}")
    return None


def _check(cfg: MelConfig, dtype: torch.dtype = torch.float32) -> None:
    err = _refusal(cfg, dtype)
    if err is not None:
        raise err


def takes(cfg: MelConfig, dtype: torch.dtype) -> bool:
    """Whether ``melspectrogram`` can run a ``dtype`` waveform under ``cfg``
    through this kernel: what ``ct_mel`` accepts, and librosa's center
    reflect pad (``ct_mel_unpadded`` folds it into the kernel's frame
    addressing)."""
    return _refusal(cfg, dtype) is None and cfg.center and cfg.pad_mode == "reflect"


@lru_cache(maxsize=None)
def _ct_operands(cfg: MelConfig):
    """Host-side numpy constants, f32: E32 ``(c32, s32)`` [n2, k2], E64
    ``(c64, s64)`` [n1, k1], the twiddle ``(tr, ti)`` [n1, k2], the window
    ``w_rs`` [n2, n1] and the filterbank ``melT`` [bin, mel] on bins
    0..1024. Each is bitwise the matching piece of the JAX package's
    ``_ct_operands`` (which packs them for the TPU's lanes)."""
    _check(cfg)
    a2 = 2 * np.pi * np.outer(np.arange(N2), np.arange(N2)) / N2
    a1 = 2 * np.pi * np.outer(np.arange(N1), np.arange(N1)) / N1
    at = 2 * np.pi * np.outer(np.arange(N1), np.arange(N2)) / N_FFT
    win = _window_array(cfg.window, cfg.win_length or N_FFT, N_FFT)
    f32 = lambda a: np.ascontiguousarray(a, dtype=np.float32)  # noqa: E731
    return (
        f32(np.cos(a2)), f32(-np.sin(a2)),
        f32(np.cos(a1)), f32(-np.sin(a1)),
        f32(np.cos(at)), f32(-np.sin(at)),
        f32(win.reshape(N2, N1)),
        f32(cfg.filterbank().T),
    )


@lru_cache(maxsize=None)
def _operands_on(cfg: MelConfig, device: torch.device) -> tuple[torch.Tensor, ...]:
    """``_ct_operands`` uploaded once per (config, device)."""
    return tuple(torch.from_numpy(a).to(device) for a in _ct_operands(cfg))


def _twiddle(exponent: np.ndarray, n: int) -> np.ndarray:
    """``W_n^exponent = exp(-2 pi i exponent / n)`` from float64, rounded to
    f32 as ``(..., 2)`` [real, imaginary] pairs."""
    angle = 2 * np.pi * (exponent % n) / n
    return np.stack([np.cos(angle), -np.sin(angle)], axis=-1).astype(np.float32)


def mel_lanes(n_mels: int) -> list[list[list[int]]]:
    """The kernel's mel pairing: for each round g, the filters the 32 lanes
    take together, first ``m = 32 g + lane`` (below ``ceil(n_mels / 2)``),
    then each one's mirror ``n_mels - 1 - m`` (but the middle filter of an
    odd count once), as ``[firsts, seconds]`` indexed by lane."""
    half = (n_mels + 1) // 2
    rounds = []
    for g in range(-(-half // LANES)):
        firsts = list(range(g * LANES, min((g + 1) * LANES, half)))
        rounds.append([firsts, [n_mels - 1 - m if n_mels - 1 - m != m else -1 for m in firsts]])
    return rounds


@lru_cache(maxsize=None)
def _kernel_operands(cfg: MelConfig, device: torch.device) -> tuple[torch.Tensor, ...]:
    """The FFT kernel's host tables, once per (config, device): the window
    ``(2048,)``; ``tw1`` ``(32 c, 32 a, 2)`` = ``W_1024^(a c)``, the pass-1
    twiddle (row c read by lanes a); ``tw2`` ``(1025, 2)`` = ``W_2048^k``, the
    real split's twiddle; ``melw`` ``(rows, 32)``, the mel weights lane by
    lane: filter m's weight for bin k at ``[row[m] + k - lo[m], lane]`` for
    the lane that sums it (``mel_lanes``), one row base for the filters the
    lanes take together; and ``spans`` ``(3, n_mels)`` int32, each filter's
    first and last-plus-one nonzero bin and its ``row``."""
    *_, w_rs, melT = _ct_operands(cfg)
    nz = melT != 0
    any_nz = nz.any(axis=0)
    lo = np.where(any_nz, nz.argmax(axis=0), 0)
    hi = np.where(any_nz, melT.shape[0] - nz[::-1].argmax(axis=0), 0)
    row = np.zeros(cfg.n_mels, np.int64)
    slots = []  # (lane, filter)
    n_rows = 0
    for together in (part for rnd in mel_lanes(cfg.n_mels) for part in rnd):
        taken = [(lane, m) for lane, m in enumerate(together) if m >= 0]
        for lane, m in taken:
            row[m] = n_rows
            slots.append((lane, m))
        n_rows += max((hi[m] - lo[m] for _, m in taken), default=0)
    melw = np.zeros((n_rows, LANES), np.float32)
    for lane, m in slots:
        melw[row[m] : row[m] + hi[m] - lo[m], lane] = melT[lo[m] : hi[m], m]
    arrays = (
        w_rs.reshape(-1),
        _twiddle(np.outer(np.arange(LANES), np.arange(LANES)), N_FFT // 2),
        _twiddle(np.arange(N_FFT // 2 + 1), N_FFT),
        melw,
        np.stack([lo, hi, row]).astype(np.int32),
    )
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays)


@lru_cache(maxsize=None)
def _kernel():
    fn = _build.load_library("ct_mel").ct_mel_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 2 + [ctypes.c_longlong] + [
        ctypes.c_int
    ] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _covering(wav_padded: torch.Tensor, cfg: MelConfig, n_frames: int) -> torch.Tensor:
    """Check the input and zero-extend it to the frames' reach where the TPU
    kernel would (it rounds the padded length up to a multiple of 64)."""
    _check(cfg, wav_padded.dtype)
    if wav_padded.dim() != 2:
        raise ValueError(f"expected (B, n_padded) waveforms, got {tuple(wav_padded.shape)}")
    n_pad = wav_padded.shape[1]
    need = (n_frames - 1) * cfg.hop_length + cfg.n_fft
    if n_frames < 1 or need > -(-n_pad // N1) * N1:
        raise ValueError("padded signal too short for n_frames")
    if need > n_pad:
        wav_padded = torch.nn.functional.pad(wav_padded, (0, need - n_pad))
    return wav_padded.contiguous()


def ct_mel_reference(
    wav_padded: torch.Tensor, cfg: MelConfig = MelConfig(), *, n_frames: int
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: frames via ``unfold``, stage A as
    a matmul over n2, the twiddle, stage C as a matmul over n1, ``|X|^2`` on
    bins 0..1024 and the mel matmul -> ``(B, n_frames, n_mels)``."""
    wav_padded = _covering(wav_padded, cfg, n_frames)
    c32, s32, c64, s64, tr, ti, w_rs, melT = _operands_on(cfg, wav_padded.device)
    frames = wav_padded.unfold(-1, N_FFT, cfg.hop_length)[:, :n_frames]
    x = frames.reshape(*frames.shape[:2], N2, N1) * w_rs  # [.., n2, n1]
    gr, gi = c32.T @ x, s32.T @ x  # [.., k2, n1]
    br = gr * tr.T - gi * ti.T
    bi = gr * ti.T + gi * tr.T
    xr = br @ c64 - bi @ s64  # [.., k2, k1]
    xi = br @ s64 + bi @ c64
    power = (xr * xr + xi * xi).transpose(-1, -2).reshape(*frames.shape[:2], N_FFT)
    return power[..., : N_FFT // 2 + 1] @ melT  # bin k = k2 + 32 k1


def ct_mel(
    wav_padded: torch.Tensor, cfg: MelConfig = MelConfig(), *, n_frames: int
) -> torch.Tensor:
    """(B, n_padded) center-padded waveforms -> (B, n_frames, n_mels) mel power.

    ``wav_padded`` carries the center padding (n_fft//2 per side). Needs
    n_fft == 2048, hop % 64 == 0 and n_fft % hop == 0 (``ValueError``
    otherwise); any batch size. On a CUDA tensor this launches the kernel
    on the current stream; on a CPU tensor it is ``ct_mel_reference``.
    """
    global launches
    wav_padded = _covering(wav_padded, cfg, n_frames)
    if not wav_padded.is_cuda:
        if wav_padded.device.type != "cpu":
            raise NotImplementedError(f"ct_mel has no path for {wav_padded.device}")
        return ct_mel_reference(wav_padded, cfg, n_frames=n_frames)
    refuse_grad(wav_padded, "ct_mel")
    out = _launch(wav_padded, cfg, n_frames, left=0)
    launches += 1
    return out


def _launch(wav: torch.Tensor, cfg: MelConfig, n_frames: int, *, left: int) -> torch.Tensor:
    """The kernel on contiguous ``(B, n_sig)`` float32 rows whose frame f
    starts at sample ``f * hop - left`` (the kernel reflects what lies
    outside a row) -> ``(B, n_frames, n_mels)``, on the current stream."""
    B, n_sig = wav.shape
    if B * n_frames >= 2**31:
        raise ValueError(f"{B * n_frames} frame rows overflow the kernel's int row index")
    win, tw1, tw2, melw, spans = _kernel_operands(cfg, wav.device)
    out = torch.empty((B, n_frames, cfg.n_mels), dtype=torch.float32, device=wav.device)
    fn = _kernel()
    with torch.cuda.device(wav.device):
        rc = fn(
            wav.data_ptr(),
            win.data_ptr(),
            tw1.data_ptr(),
            tw2.data_ptr(),
            melw.data_ptr(),
            spans.data_ptr(),
            out.data_ptr(),
            B * n_frames,
            n_frames,
            n_sig,
            left,
            cfg.hop_length,
            cfg.n_mels,
            torch.cuda.current_stream(wav.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"ct_mel kernel launch failed with CUDA error {rc}")
    return out


def ct_mel_unpadded(y: torch.Tensor, cfg: MelConfig) -> torch.Tensor:
    """``(..., n)`` raw waveforms -> ``(..., T, n_mels)`` with librosa's
    center padding (``melspectrogram``'s CUDA route at the parity profile).

    On a CUDA tensor with reflect padding the kernel reads the raw rows and
    reflects the edge frames' samples itself: bitwise ``ct_mel`` of the
    padded rows, without the padded copy. Otherwise ``center_pad`` (under
    the ``mel.pad`` span) and ``ct_mel``."""
    global launches, reflect_launches
    lead, n = y.shape[:-1], y.shape[-1]
    n_frames = 1 + n // cfg.hop_length
    flat = y.reshape(-1, n)
    if not flat.is_cuda or cfg.pad_mode != "reflect":
        with span("mel.pad"):
            padded = center_pad(flat, cfg.n_fft, cfg.pad_mode)
        return ct_mel(padded, cfg, n_frames=n_frames).reshape(*lead, n_frames, cfg.n_mels)
    _check(cfg, flat.dtype)
    pad = cfg.n_fft // 2
    if n <= pad:  # as F.pad's reflect mode refuses it
        raise RuntimeError(
            f"Padding size should be less than the corresponding input dimension, but got: "
            f"padding ({pad}, {pad}) of an input of {n} samples"
        )
    refuse_grad(flat, "ct_mel")
    mel = _launch(flat.contiguous(), cfg, n_frames, left=pad)
    launches += 1
    reflect_launches += 1
    return mel.reshape(*lead, n_frames, cfg.n_mels)


def ct_log_mel(
    wav: torch.Tensor,
    cfg: MelConfig = MelConfig(),
    *,
    ref="max",
    top_db: float | None = 80.0,
) -> torch.Tensor:
    """Drop-in (B, n) -> (B, n_mels, T) log-mel via the CT kernel.

    As in the JAX package, the signal is always center padded with
    ``cfg.pad_mode`` and T = 1 + n // hop."""
    mel = ct_mel_unpadded(wav, cfg).transpose(-1, -2)
    return power_to_db(mel, ref=ref, top_db=top_db, utt_axes=2)
