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

``ct_mel_db`` launches the kernel's dB instance on raw waveforms: one block
an utterance keeps the (T, n_mels) power in shared memory and writes
``power_to_db(ref="max", top_db)`` of it, bitwise ``power_to_db`` of
``ct_mel_unpadded``'s power, so no power tensor reaches device memory.
``ct_log_mel`` and ``frontend/mel.py::log_mel_spectrogram`` take it where
``db_refusals`` names no reason, and ``ct_mel_unpadded`` + ``power_to_db``
everywhere else.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from audioanalysisdetector_tpu_torch.frontend.db import power_to_db
from audioanalysisdetector_tpu_torch.frontend.mel import MelConfig
from audioanalysisdetector_tpu_torch.frontend.stft import _window_array, center_pad, n_frames_for
from audioanalysisdetector_tpu_torch.ops import _build, launch, on_card
from audioanalysisdetector_tpu_torch.utils.profiling import span

N1 = 64  # in-chunk offset / stage-C DFT length
N2 = 32  # chunk index / stage-A DFT length
N_FFT = N1 * N2
LANES = 32  # the FFT kernel's warp: one frame row, 32 x 32 registers
# ct_mel_launch(wav, win, tw1, tw2, melw, spans, out, n_rows, n_frames, n_sig, left, hop, n_mels, stream)
_ARGTYPES = (
    (ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 2 + (ctypes.c_longlong,) + (ctypes.c_int,) * 3 + (ctypes.c_void_p,)
)
# ct_mel_db_launch: the same, then top_db (negative: no clip) before the stream
_DB_ARGTYPES = _ARGTYPES[:-1] + (ctypes.c_float, ctypes.c_void_p)
DB_AMIN = 1e-10  # the dB instance's amin, power_to_db's default
# the dB instance's dynamic shared memory: the 8 warps' transpose tiles, then
# the (T, n_mels) mel tile and 16 floats; at most what leaves two blocks an SM
_DB_TILES_BYTES = 8 * 32 * 33 * 8
_DB_SMEM_MAX = 228 * 1024 // 2 - 1024


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
    wav_padded = _covering(wav_padded, cfg, n_frames)
    if not on_card(wav_padded, "ct_mel"):
        return ct_mel_reference(wav_padded, cfg, n_frames=n_frames)
    return _launch(wav_padded, cfg, n_frames, left=0)


def _launch(
    wav: torch.Tensor, cfg: MelConfig, n_frames: int, *, left: int, db: bool = False, top_db: float | None = None
) -> torch.Tensor:
    """The kernel on contiguous ``(B, n_sig)`` float32 rows whose frame f
    starts at sample ``f * hop - left`` (the kernel reflects what lies
    outside a row) -> ``(B, n_frames, n_mels)``, on the current stream: the
    mel power, or with ``db`` each utterance's ``power_to_db(ref="max",
    top_db)``. A launch on raw rows (``left`` > 0) also counts as
    ``ct_mel.reflect``, a dB launch as ``ct_mel.db``."""
    B, n_sig = wav.shape
    win, tw1, tw2, melw, spans = _kernel_operands(cfg, wav.device)
    out = torch.empty((B, n_frames, cfg.n_mels), dtype=torch.float32, device=wav.device)
    args = (
        wav.data_ptr(), win.data_ptr(), tw1.data_ptr(), tw2.data_ptr(), melw.data_ptr(), spans.data_ptr(),
        out.data_ptr(), B * n_frames, n_frames, n_sig, left, cfg.hop_length, cfg.n_mels,
    )
    counters = ("ct_mel.reflect",) if left else ()
    if db:
        entry = _build.entry_point("ct_mel", "ct_mel_db_launch", _DB_ARGTYPES)
        args += (-1.0 if top_db is None else float(top_db),)
        counters += ("ct_mel.db",)
    else:
        entry = _build.entry_point("ct_mel", "ct_mel_launch", _ARGTYPES)
    launch(entry, wav, "ct_mel", *args, rows=B * n_frames, counters=counters)
    return out


def _raw_rows(flat: torch.Tensor, cfg: MelConfig) -> torch.Tensor:
    """``(B, n)`` raw rows for a launch with ``left = n_fft // 2``, contiguous,
    after the checks ``center_pad``'s reflect mode would make."""
    _check(cfg, flat.dtype)
    pad = cfg.n_fft // 2
    if flat.shape[-1] <= pad:  # as F.pad's reflect mode refuses it
        raise RuntimeError(
            f"Padding size should be less than the corresponding input dimension, but got: "
            f"padding ({pad}, {pad}) of an input of {flat.shape[-1]} samples"
        )
    return flat.contiguous()


def ct_mel_unpadded(y: torch.Tensor, cfg: MelConfig) -> torch.Tensor:
    """``(..., n)`` raw waveforms -> ``(..., T, n_mels)`` with librosa's
    center padding (``melspectrogram``'s CUDA route at the parity profile).

    On a CUDA tensor with reflect padding the kernel reads the raw rows and
    reflects the edge frames' samples itself: bitwise ``ct_mel`` of the
    padded rows, without the padded copy. Otherwise ``center_pad`` (under
    the ``mel.pad`` span) and ``ct_mel``."""
    lead, n = y.shape[:-1], y.shape[-1]
    n_frames = n_frames_for(n, cfg.hop_length, cfg.n_fft, center=True)
    flat = y.reshape(-1, n)
    if not flat.is_cuda or cfg.pad_mode != "reflect":
        with span("mel.pad"):
            padded = center_pad(flat, cfg.n_fft, cfg.pad_mode)
        return ct_mel(padded, cfg, n_frames=n_frames).reshape(*lead, n_frames, cfg.n_mels)
    rows = _raw_rows(flat, cfg)
    return _launch(rows, cfg, n_frames, left=cfg.n_fft // 2).reshape(*lead, n_frames, cfg.n_mels)


def db_refusals(
    y: torch.Tensor, cfg: MelConfig, *, ref: float | str = "max", top_db: float | None = 80.0, amin: float = DB_AMIN
) -> list[str]:
    """Why K3's dB instance cannot compute ``power_to_db(melspectrogram(y,
    cfg), ref=ref, amin=amin, top_db=top_db)``, each reason by name, or an
    empty list: it takes float32 waveforms on the card, under a
    configuration ``melspectrogram`` sends to K3 (``mel_route`` ``"ct_mel"``,
    ``method="matmul"``), ``ref="max"``, ``top_db`` None or >= 0, amin 1e-10,
    a (T, n_mels) mel tile that leaves two blocks an SM (T * n_mels <=
    12,016: 64 mels up to T = 187, 5.9-s clips at hop 512), and no backward
    (autograd would need one when grad mode is on and ``y`` requires grad)."""
    why = []
    if not y.is_cuda:
        why.append("device")
    if y.dtype != torch.float32:
        why.append("dtype")
    if not takes(cfg, torch.float32) or cfg.method != "matmul":
        why.append("config")
    if not (isinstance(ref, str) and ref == "max"):
        why.append("ref")
    if top_db is not None and not top_db >= 0:
        why.append("top_db")
    if amin != DB_AMIN:
        why.append("amin")
    n_frames = 1 + (y.shape[-1] if y.dim() else 0) // cfg.hop_length
    if _DB_TILES_BYTES + 4 * (n_frames * cfg.n_mels + 16) > _DB_SMEM_MAX:
        why.append("tile")
    if torch.is_grad_enabled() and y.requires_grad:
        why.append("grad")
    return why


def ct_mel_db(y: torch.Tensor, cfg: MelConfig = MelConfig(), *, top_db: float | None = 80.0) -> torch.Tensor:
    """``(..., n)`` raw float32 waveforms on the card -> ``(..., T, n_mels)``
    log-mel in dB through K3's dB instance, in one launch: bitwise
    ``power_to_db(ct_mel_unpadded(y, cfg).transpose(-1, -2), ref="max",
    top_db=top_db).transpose(-1, -2)``, in ``ct_mel_unpadded``'s layout.
    Call it where ``db_refusals(y, cfg, top_db=top_db)`` is empty; a signal
    of n_fft // 2 samples or fewer raises what ``center_pad`` raises."""
    if not on_card(y, "ct_mel"):
        raise ValueError("K3's dB instance runs on the card: log_mel_spectrogram computes a CPU tensor")
    why = [r for r in db_refusals(y, cfg, top_db=top_db) if r not in ("device", "grad")]  # launch raises on grad
    if why:
        raise ValueError(f"K3's dB instance cannot take this input: {', '.join(why)}")
    lead, n = y.shape[:-1], y.shape[-1]
    n_frames = 1 + n // cfg.hop_length
    rows = _raw_rows(y.reshape(-1, n), cfg)
    out = _launch(rows, cfg, n_frames, left=cfg.n_fft // 2, db=True, top_db=top_db)
    return out.reshape(*lead, n_frames, cfg.n_mels)


def ct_log_mel(
    wav: torch.Tensor,
    cfg: MelConfig = MelConfig(),
    *,
    ref="max",
    top_db: float | None = 80.0,
) -> torch.Tensor:
    """Drop-in (B, n) -> (B, n_mels, T) log-mel via the CT kernel.

    As in the JAX package, the signal is always center padded with
    ``cfg.pad_mode`` and T = 1 + n // hop. Where ``db_refusals`` names no
    reason, K3 writes the dB itself (``ct_mel_db``); else ``power_to_db``
    of ``ct_mel_unpadded``'s power."""
    if not db_refusals(wav, cfg, ref=ref, top_db=top_db):
        return ct_mel_db(wav, cfg, top_db=top_db).transpose(-1, -2)
    mel = ct_mel_unpadded(wav, cfg).transpose(-1, -2)
    return power_to_db(mel, ref=ref, top_db=top_db, utt_axes=2)
