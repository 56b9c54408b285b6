#!/usr/bin/env python3
"""Card check of the PyTorch port: build, kernels vs plain, e2e, serving, CLI, training, features.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

It drives ``audioanalysisdetector_tpu_torch``'s main path (wav -> log-mel
through the hand-written mel kernel that ``frontend.mel.mel_route`` names —
``ct_mel`` (K3) at the parity profile, ``wave_mel`` (K1) at speech ->
CNN-BiLSTM -> score) at the flagship model's full width, in phases that
each print their lines:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA;
2. build: compiles ``ops/csrc/wave_mel.cu`` (K1 and K2) and
   ``ops/csrc/ct_mel.cu`` (K3) with nvcc, one process each, in parallel,
   and counts the tensor-core (``HGMMA``) instructions in wave_mel's SASS
   (``cuobjdump -sass``): none fails the phase;
3. K1: ``wave_mel`` against ``wave_mel_reference`` in both mel profiles
   (random input at B=8192, a ragged batch of 13, silence, length 32001,
   whose rows are not 16-byte aligned), at n_fft 400 / hop 160 (the 25 ms
   / 10 ms speech framing, a sample tail past the kernel's 32-sample
   stages), at n_fft 64 (fewer stages than the ring is deep) and with 128
   mels, mel power and dB; then the configurations K1 took up last (power
   1, a bfloat16 waveform, also off 16-byte alignment, and 256 mels in two
   filter groups), each through ``melspectrogram``'s route too; then the
   kernel, plain and library times from CUDA events, in turns, beside the
   bound, for both profiles and the three new configurations at B=8192;
4. K3: ``ct_mel`` against ``ct_mel_reference`` and against K1's direct
   plain chain at parity (random B=8192, ragged 13, silence, length 32032,
   length 32001, whose odd padded rows take the 4-byte loads, 128 and 256
   mels), its log-mel against the plain dB, its time against its plain
   version, the library chain and K1 in turns, beside the bound;
5. K2: ``fused_mel_from_frames`` against its plain version in float32 and
   bfloat16 (8192 utterances' frames, a ragged 100) in both profiles, with
   128 mels and at n_fft 100 off alignment, bf16 against f32, the times
   beside the bound and the library chain; then the drop-in
   ``fused_log_mel_spectrogram`` path in both dtypes, counting its launches;
6. e2e: the scorer at B=8192 x 2 s in both profiles, against the same model
   fed the plain mel path, plus a float64 numpy check of the features, and
   a ``torch.profiler`` breakdown of one call (host wall, device kernel
   time, busy share, the largest kernels);
7. serving: 8 concurrent PCM requests and one ``audio_b64`` WAV and one FLAC
   through BatchingScorer/ScoreServer;
8. score: 64 two-second WAV and FLAC files through
   ``python -m audioanalysisdetector_tpu_torch score`` in a subprocess,
   against the direct scorer on the decoded rows;
9. fused: the flagship wav -> CQCC -> GMM ⊕ BiLSTM scorer
   (``make_cqcc_fused_scorer``) at full width (BiLSTM hidden 128, two
   128-component GMMs, 84-bin CQT, 19 CQCCs) on B=8192 two-second
   utterances: ms per batch, utt/s and a ``torch.profiler`` breakdown, 256
   rows against the port on the CPU; the same features through
   ``make_fused_scorer`` with the deltas + CMVN frame transform (D = 57
   GMMs); ``eval_model`` over a model dir written with ``to_numpy``, on the
   card and on the CPU. The path reaches no TPU kernel (XLA computed it in
   the JAX package), so it runs plain PyTorch: cuBLAS, cuDNN;
10. train: 8192 two-second utterances made on the card (bonafide noise,
    spoof noise plus a seeded tone), log-mel at parity through K3 under
    ``torch.no_grad()``; 5 train steps of the full-width CNN-BiLSTM from one
    converted init, dropout 0, on the card against the CPU (losses and
    BatchNorm statistics); ``fit`` for 2 epochs at batch 256 (80/20 split,
    Adam 1e-4) whose train loss must fall; ms per train step and train
    utt/s at batch 256 and 16 with a ``device_breakdown`` of one step;
    ``bilstm_pipeline`` (hidden 128) on the phase's CQCC features, card
    against CPU over 3 steps; the ``train`` CLI over 64 WAVs in a
    subprocess, its ``best_model.msgpack`` read by the ``score`` CLI; the
    grad guard: each mel kernel refuses an input that requires grad;
11. gmm-train: GMM-UBM training at the reference's scale (1.8M frames of
    19 coefficients from 8 seeded centres, 128 components, 100 EM
    iterations, ``benchmarks/bench_gmm.py``'s setup): ``fit_em`` through
    the flat and the chunked E-step (s per fit, ms per iteration, peak
    memory; parameters and mean LL held to each other), ``map_adapt``
    against ``map_adapt_chunked`` on both halves of the buffer, means only
    and full (ms per MAP); ``fit_em`` (20k frames, K = 16) and
    ``train_gmm_system`` (K = 128 on the CQCC of 512 utterances, plain and
    CMVN) on the card against the CPU; ``eval_model``'s training branch; the
    ``train-fused`` CLI over 64 WAVs and ``train-asvspoof`` on a reduced v5
    surrogate corpus (its cuts in ``phase_gmm_train``), with the time of
    each stage. No TPU kernel is on this path: plain PyTorch;
12. features: the slice's extractors on 8192 two-second utterances made on
    the card: the seven ``data.pipeline.default_extractors`` (mfcc, lfcc,
    cqcc, gtcc, wpt, mel_spectrogram, mfcc_deltas) plus
    ``melspectrogram_znorm`` and ``compute_cqt_spec``, each at B=8192
    against the port on the CPU (256 rows), with ms per batch, utt/s and
    peak memory; the mel features run K3 and count its launches; K3 at 128
    mels (the MFCC configuration) against its plain version, bound and
    cuFFT chain; ``apply_augmentations`` on a none/pitch/noise mix (pitch
    rows against the CPU, the noise rows' residual std, none rows
    unchanged) and a full-batch pitch shift, with ms and peak memory; the
    iSTFT round trip; the formants cells over 16 files against the CPU; the
    ``extract`` CLI in subprocesses over 64 WAVs (mfcc and lfcc) against
    ``extract_feature_array``; the ``augment`` CLI over 8 WAVs (24 files);
    ``train-asvspoof --augment`` on phase 11's corpus (finite EERs, more
    train rows than without). Apart from K3 under the mel features, the
    path ran on XLA in the JAX package: plain PyTorch;
13. the result: a JSON line of the kernels, then ``{"ok": true, ...}`` last.

Each path's kernel launches are counted with every counter set to 0 just
before it and read just after (``run_counted``); a phase fails when the
kernel its route names did not launch. Every failure raises and exits
nonzero; without a CUDA card it exits 1 before printing any result. Weights
are random, from a seed.
"""

from __future__ import annotations

import atexit
import base64
import contextlib
import functools
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

from audioanalysisdetector_tpu_torch.convert import (
    flax_to_torch_bilstm_classifier,
    flax_to_torch_cnn_bilstm,
    random_diag_gmm,
    random_flax_bilstm_classifier,
    random_flax_cnn_bilstm,
)
from audioanalysisdetector_tpu_torch.data.scaler import FrameScaler
from audioanalysisdetector_tpu_torch.frontend.cqcc import CQCCConfig, cqcc, transpose_cqcc
from audioanalysisdetector_tpu_torch.frontend.db import power_to_db
from audioanalysisdetector_tpu_torch.frontend.mel import (
    MelConfig,
    log_mel_spectrogram,
    mel_route,
    melspectrogram,
)
from audioanalysisdetector_tpu_torch.frontend.mfcc import MFCCConfig
from audioanalysisdetector_tpu_torch.frontend.stft import (
    _window_array,
    center_pad,
    frame_signal,
    n_frames_for,
)
from audioanalysisdetector_tpu_torch.io.audio import write_wav
from audioanalysisdetector_tpu_torch.io.flac import write_flac
from audioanalysisdetector_tpu_torch.io.native_loader import (
    load_chunk_batch_native,
    native_available,
)
from audioanalysisdetector_tpu_torch.models.bilstm_classifier import BiLSTMClassifier
from audioanalysisdetector_tpu_torch.models.cnn_bilstm import CNNBiLSTMHybrid
from audioanalysisdetector_tpu_torch.models.gmm import (
    _em_step,
    _em_step_flat,
    _pad_on_device,
    fit_em,
    from_numpy,
    map_adapt,
    map_adapt_chunked,
    score_samples,
    to_numpy,
)
from audioanalysisdetector_tpu_torch.models.layers import flax_init_
from audioanalysisdetector_tpu_torch.ops import _build, launch_counts, reset_launch_counts
from audioanalysisdetector_tpu_torch.ops import ct_mel as ctm  # the modules: counters
from audioanalysisdetector_tpu_torch.ops import fused_logmel as flm
from audioanalysisdetector_tpu_torch.ops import wave_mel as wm
from audioanalysisdetector_tpu_torch.score.e2e import (
    init_mel_cnn_bilstm,
    make_cqcc_fused_scorer,
    make_mel_cnn_bilstm_scorer,
)
from audioanalysisdetector_tpu_torch.score.fused import make_fused_scorer
from audioanalysisdetector_tpu_torch.train import (
    TrainState,
    bilstm_pipeline,
    fit,
    get_loss,
    make_optimizer,
    make_train_step,
)
from audioanalysisdetector_tpu_torch.train.gmm_system import eval_model, make_gmm_feature_fn, train_gmm_system
from audioanalysisdetector_tpu_torch.serve.server import (
    BatchingScorer,
    ScoreServer,
    build_mel_scorer,
    default_bucket_ladder,
)

ROOT = Path(__file__).resolve().parent
SR, N_SAMPLES, BATCH = 16000, 32000, 8192
DEVICE = "cuda"
PROFILES = ("parity", "speech")
# Mel power, kernel vs plain, relative to each utterance's (or frame row's)
# max power: both are fp32 sums of up to n_fft products and of the mel
# contraction, taken in different orders (and, for K3, through another
# factorization of the same DFT), so they differ by rounding of order
# sqrt(n_fft) * 2^-24 of the largest terms; 1e-4 leaves two decades.
REL_TOL = 1e-4
# log-mel, kernel vs plain, in dB: a relative power error e moves dB by
# 4.3 e, and top_db=80 keeps values within 80 dB of the per-utterance max.
DB_TOL = 1e-3
# the same past 128 mels: at n_fft 512 the 256 Slaney filters below ~1 kHz
# are narrower than the 31.25 Hz bin spacing, so many hold one bin at an
# edge weight and their power is that bin's alone, down to the -80 dB
# floor, with no neighbour to average its relative DFT error (the CPU
# emulation of the kernel reads 9.2e-4 dB at -70.6 dB on 16 rows; an H100
# 7.7e-3 dB on 8192 rows, at 2.9e-6 of the max power)
DB_TOL_MANY_MELS = 3e-2
# The published peaks of one H100 SXM at 700 W (NVIDIA's data sheet) that
# ``mel_bound`` divides by: fp32 outside the tensor cores, and HBM3.
FP32_FLOP_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12
# K2 in bf16 against its f32 result: the median relative error of the mel
# power (the bound of the JAX package's tests/test_ops_pallas.py:54)
BF16_MEDIAN_TOL = 0.02
# scores, scorer (kernel) vs the same model fed the plain mel path
SCORE_TOL = 1e-4
# serving and the CLI vs the direct scorer on the same rows: other batch
# sizes may pick other cuDNN / cuBLAS algorithms for the model
SERVE_TOL = 1e-5
# fused scores, card vs the port on the CPU: fp32 CQT, GMM and LSTM chains
# summed in other orders, through the CQCC's log(dB^2 + 1e-12) quirk
FUSED_TOL = 1e-4
# train steps, card vs the CPU from the same weights on the same batches
# (dropout 0, Adam 1e-4): the losses of 5 steps relative to their size, and
# the BatchNorm running statistics after them relative to their largest
# entry. Adam's first steps move every weight by about lr whatever its
# gradient's size, so a conv weight whose gradient is near its rounding
# noise (and the conv bias, whose gradient is zero in exact arithmetic
# under the BatchNorm) can step apart by 2 lr on the two devices; the conv
# outputs, of inputs ~40 dB in size, and their running statistics carry
# that (an H100 read 3.4e-4 of the largest mean and 1.1e-4 of the largest
# variance), while the losses stay within ~1e-6
TRAIN_LOSS_RTOL = 1e-4
TRAIN_BN_RTOL = 2e-3
TRAIN_ROWS, TRAIN_BATCH = 8192, 256
# GMM-UBM training at the reference's scale (benchmarks/bench_gmm.py:30-34:
# ~1.8M CQCC frames of 19 coefficients, 128 components, 100 EM iterations)
GMM_FRAMES, GMM_DIM, GMM_K = 1_800_000, 19, 128
# EM, flat against chunked path, over 100 iterations (tol 0): the
# statistics of 1.8M frames summed in one GEMM or over 28 chunks differ by
# rounding, and EM carries that on through components that share one of
# the 8 centres (an H100 read 1.8e-4 of the largest mean; a CPU run at
# 200k frames 6.6e-4 of the largest variance, 2.4e-4 after 5 iterations);
# relative to each array's largest entry. The mean log-likelihood of the
# two fits on the frames is the robust scalar (the H100 read them equal).
EM_PATH_RTOL = 2e-3
EM_LL_RTOL = 1e-5
# MAP, flat against chunked: one E-step's statistics summed in one GEMM or
# over 28 chunks (an H100 read 3.1e-5 in the full update, 1.4e-6 means only)
MAP_RTOL = 2e-4
# EM and train_gmm_system, card against CPU from the same frames, at a
# fixed number of iterations (tol 0, or max_iter 10 where the system's tol
# 1e-3 stays unreached): fp32 statistics summed in other orders (an H100
# read 1.5e-5 and 8.9e-6). Left to tol 1e-3, the noise frames' EM still
# gains ~1e-3 of LL an iteration at its 30th, the two devices' LLs differ
# by ~4e-6, and that decides whether the stop falls one iteration earlier
# or later (measured 30 against 31 iterations, parameters 1.3e-2 apart).
GMM_DEVICE_RTOL = 1e-4
# Phase 12, each extractor at B=8192 on the card against the port on the
# CPU (256 rows), max |card - CPU| relative to each row's largest |value|:
# fp32 GEMMs (cuBLAS, TF32 off) and cuDNN's conv1d summed in other orders,
# K3's FFT against the plain DFT chain under the mel features, through
# log/dB, the DCT and the z-norms. An H100 read 2.8e-7 (wpt) to 1.2e-6
# (melspectrogram_znorm), and 1.3e-4 for compute_cqt_spec, whose deepest
# bins' dB (at -80 dB from the utterance's max) carry the CQT's rounding
FEATURE_RTOL = {"mfcc": 1e-4, "lfcc": 1e-4, "cqcc": 1e-3, "gtcc": 1e-4, "wpt": 1e-4,
                "mel_spectrogram": 1e-4, "mfcc_deltas": 1e-3, "melspectrogram_znorm": 1e-3,
                "compute_cqt_spec": 1e-3}
# pitch-shifted rows, card against CPU, relative to each row's peak, inside
# and in the last n_fft samples (tests/test_torch_augment.py's bands for
# the CPU against the JAX package): the phase vocoder's cumulative phase
# reaches ~1e4 rad, where one float32 ulp is ~1e-3 rad, and the card's
# parallel scan rounds it otherwise than the CPU's sequential cumsum; the
# iSTFT divides that by a squared-window sum that falls in the tail (an
# H100 read 1.7e-3 inside and 1.8e-3 in the tail on phase 12's noise; the
# CPU against JAX 1.5e-2 in the tail of a tone)
PITCH_RTOL, PITCH_TAIL_RTOL, PITCH_TAIL = 5e-3, 3e-2, 2048
# the noise rows' residual std against the factor (0.005), over ~87M draws
# (an H100 read 0.005000)
NOISE_STD_TOL = 5e-5
# the extract CLI against extract_feature_array on the same rows and batch
# size, on the card, relative to each row's largest |value| (an H100 read
# 0: the same kernels on the same shapes)
EXTRACT_CLI_RTOL = 1e-5
KERNEL_SOURCES = {
    "wave_mel": ("ops/csrc/wave_mel.cu", "audioanalysisdetector_tpu/ops/wave_mel.py:63"),
    "fused_mel_from_frames": ("ops/csrc/wave_mel.cu", "audioanalysisdetector_tpu/ops/fused_logmel.py:84"),
    "ct_mel": ("ops/csrc/ct_mel.cu", "audioanalysisdetector_tpu/ops/ct_mel.py:154"),
}


def log(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()), flush=True)


def cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds per call of ``fn`` over ``iters`` calls (CUDA events)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def in_turns(kern, plain, library=None, iters: int = 5) -> dict:
    """Kernel and plain times (and the library call's, when given) in turns,
    plain-kernel-library-library-kernel-plain, so drift hits all alike."""
    fns = [plain, kern] + ([library] if library else [])
    for f in fns:
        f()
    torch.cuda.synchronize()
    t = [cuda_ms(f, iters) for f in fns + fns[::-1]]
    n = len(fns)
    out = {"ms": (t[1] + t[-2]) / 2, "plain_ms": (t[0] + t[-1]) / 2,
           "runs": (t[1], t[-2]), "plain_runs": (t[0], t[-1]), "library_ms": None}
    if library:
        out.update(library_ms=(t[n - 1] + t[n]) / 2, library_runs=(t[n - 1], t[n]))
    return out


def mel_bound(cfg: MelConfig, rows: int, in_bytes: int) -> dict:
    """The least time the card could take for mel power over ``rows``
    frames: the larger of the operations of a real FFT, window, |X|^2 and
    the mel weights, 2.5 N log2 N + N + 3 (N/2 + 1) + 2 nnz(mel) per frame
    at FP32_FLOP_PER_S, and the bytes, ``in_bytes`` read once and the f32
    output written once, at HBM_BYTES_PER_S."""
    n = cfg.n_fft
    nnz = int(np.count_nonzero(cfg.filterbank()))
    ops = rows * (2.5 * n * np.log2(n) + n + 3 * (n // 2 + 1) + 2 * nnz)
    ops_ms = float(ops / FP32_FLOP_PER_S * 1e3)
    bytes_ms = (in_bytes + rows * cfg.n_mels * 4) / HBM_BYTES_PER_S * 1e3
    by = "operations" if ops_ms >= bytes_ms else "bytes"
    return {"bound_ms": max(ops_ms, bytes_ms), "bound_by": by, "ops_ms": ops_ms, "bytes_ms": bytes_ms}


def _window_and_melT(cfg: MelConfig) -> tuple[torch.Tensor, torch.Tensor]:
    win = _window_array(cfg.window, cfg.win_length or cfg.n_fft, cfg.n_fft)
    return (torch.from_numpy(np.asarray(win, np.float32)).to(DEVICE),
            torch.from_numpy(np.ascontiguousarray(cfg.filterbank().T, np.float32)).to(DEVICE))


def stft_chain(padded: torch.Tensor, cfg: MelConfig):
    """The library yardstick for K1 and K3 (timed, never used by the port):
    cuFFT's ``torch.stft`` of the same center-padded rows (center=False:
    the kernels take the padding as input), |.|^power, the mel matmul. cuFFT
    takes no bf16, so a bf16 waveform is widened to f32 first."""
    win, melT = _window_and_melT(cfg)
    x = padded.float()

    def chain():
        mag = torch.stft(x, cfg.n_fft, cfg.hop_length, window=win, center=False, return_complex=True).abs()
        return (mag.square() if cfg.power == 2 else mag.pow(cfg.power)).transpose(1, 2) @ melT

    return chain


def rfft_chain(frames: torch.Tensor, cfg: MelConfig):
    """The library yardstick for K2: ``torch.fft.rfft`` of the windowed frames, |.|^2, mel."""
    win, melT = _window_and_melT(cfg)
    return lambda: torch.fft.rfft(frames * win).abs().square() @ melT


def device_breakdown(fn, iters: int = 5, top: int = 8) -> tuple[float, float, list]:
    """Where one call of ``fn`` spends its time: (host wall ms, summed device
    kernel ms, the ``top`` kernels as (ms, launches, name)), per call. The
    kernels come from ``torch.profiler`` over ``iters`` calls; the wall from
    a separate synchronised loop, so the profiler's own cost stays out of it.
    Their ratio is the card's busy share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / iters
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    per_kernel: dict[str, list] = {}
    for e in prof.events():
        # a user annotation (the optimizer's step range) spans kernels counted here
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            acc = per_kernel.setdefault(e.name, [0.0, 0])
            acc[0] += e.device_time_total / 1e3 / iters
            acc[1] += 1
    ranked = sorted(((ms, n // iters, name) for name, (ms, n) in per_kernel.items()), reverse=True)
    return wall, sum(ms for ms, _, _ in ranked), ranked[:top]


def host_ops(fn, iters: int = 5, top: int = 8) -> list:
    """Where one call of ``fn`` spends host time: the ``top`` operators by
    self CPU time per call, as (ms, calls, name), from ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    ops = [(e.self_cpu_time_total / 1e3 / iters, e.count // iters, e.key) for e in prof.key_averages()]
    return sorted(ops, reverse=True)[:top]


def bound_fields(t: dict, bound: dict) -> dict:
    """A log line's view of a timing: the bound, the share of it the kernel
    reaches, and the library call's time where there is one."""
    out = {"bound_ms": f"{bound['bound_ms']:.3f}", "bound_by": bound["bound_by"],
           "bound_ops_ms": f"{bound['ops_ms']:.3f}", "bound_bytes_ms": f"{bound['bytes_ms']:.3f}",
           "share_of_bound": f"{bound['bound_ms'] / t['ms']:.4f}"}
    if t["library_ms"] is not None:
        out.update(library_ms=f"{t['library_ms']:.3f}", library_runs="%.3f,%.3f" % t["library_runs"])
    return out


def run_counted(fn):
    """(fn(), launches by kernel): every counter is set to 0 just before the
    call and read just after it, once the card has finished."""
    reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, launch_counts()


def expect_launched(counts: dict, kernel: str, where: str) -> int:
    if counts[kernel] < 1:
        raise AssertionError(f"{where}: the routed kernel {kernel} did not launch ({counts})")
    return counts[kernel]


def waves(batch: int, seed: int, n: int = N_SAMPLES) -> torch.Tensor:
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    return 0.1 * torch.randn((batch, n), generator=g, device=DEVICE)


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    """max |got - ref| relative to each utterance's (row's) max |ref| (0 for silence)."""
    peak = ref.abs().amax(dim=tuple(range(1, ref.dim())), keepdim=True).clamp_min(1e-30)
    return float(((got - ref).abs() / peak).max())


def free() -> None:
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def phase_device() -> str:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: no card", file=sys.stderr)
        raise SystemExit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    log("device", torch=torch.__version__, cuda=torch.version.cuda,
        kind=repr(torch.cuda.get_device_name(0)), count=torch.cuda.device_count())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def hgmma_count(library: str) -> int:
    """Tensor-core (wgmma) instructions in a built library's SASS."""
    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run(
        [str(cuobjdump), "-sass", library], capture_output=True, text=True, check=True
    ).stdout
    return sum("HGMMA" in line for line in sass.splitlines())


def phase_build() -> None:
    t0 = time.perf_counter()
    libs = ("wave_mel", "ct_mel")
    with ThreadPoolExecutor(len(libs)) as pool:  # one nvcc per source, all at once
        list(pool.map(_build.load_library, libs))
    for name in libs:
        info = _build.build_log[name]
        log("build", source=f"{name}.cu", nvcc_s=f"{info['seconds']:.2f}")
        for line in info["output"].splitlines():
            if "registers" in line or "spill" in line:
                print("  ptxas: " + line.strip(), flush=True)
    n = hgmma_count(_build.build_log["wave_mel"]["path"])
    log("build", source="wave_mel.cu", hgmma=n)
    if n == 0:
        raise AssertionError("wave_mel.cu built without tensor-core (HGMMA) instructions")
    log("build", wall_s=f"{time.perf_counter() - t0:.2f}")


K1_CASES = (("random", BATCH, N_SAMPLES), ("ragged", 13, N_SAMPLES), ("silence", 64, N_SAMPLES),
            ("length32001", 64, 32001))
K1_WIDE = ("power1", "bf16", "mels256")  # beyond power 2, float32 and 128 mels


def phase_k1() -> dict:
    """K1 vs plain in both profiles, at n_fft 400 and 64 and with 128 mels;
    returns the numbers (and times) of the two profiles."""
    results = {}
    configs = [(p, MelConfig.for_profile(p, SR), K1_CASES) for p in PROFILES]
    configs.append(("n_fft400", MelConfig(sr=SR, n_fft=400, hop_length=160),
                    (("random", 64, N_SAMPLES), ("length32001", 13, 32001))))
    configs.append(("mels128", MelConfig.for_speech(SR, n_mels=128), (("ragged", 13, N_SAMPLES),)))
    # fewer 32-sample stages than the ring is deep
    configs.append(("n_fft64", MelConfig(sr=SR, n_fft=64, hop_length=32, n_mels=16),
                    (("ragged", 13, N_SAMPLES),)))
    # what K1 took up last: |X|^power, bf16 waveforms (length 32001: odd
    # bf16 rows, the 2-byte loads) and two groups of 128 filters
    speech = MelConfig.for_speech(SR)
    configs += [("power1", replace(speech, power=1.0), K1_CASES[:2]),
                ("bf16", speech, K1_CASES[:2] + (("length32001", 13, 32001),)),
                ("mels256", MelConfig.for_speech(SR, n_mels=256), K1_CASES[:2])]
    for profile, cfg, cases in configs:
        dtype = torch.bfloat16 if profile == "bf16" else torch.float32
        max_abs, max_rel, max_db = 0.0, 0.0, 0.0
        for case, batch, n in cases:
            T = n_frames_for(n, cfg.hop_length, cfg.n_fft, cfg.center)
            wav = waves(batch, 1, n) if case != "silence" else torch.zeros((batch, n), device=DEVICE)
            wav = wav.to(dtype)
            padded = center_pad(wav, cfg.n_fft, cfg.pad_mode).contiguous()
            got = wm.wave_mel(padded, cfg, n_frames=T)
            ref = wm.wave_mel_reference(padded, cfg, n_frames=T)
            torch.cuda.synchronize()
            if got.shape != (batch, T, cfg.n_mels) or not torch.isfinite(got).all():
                raise AssertionError(f"{profile}/{case}: bad kernel output {tuple(got.shape)}")
            rel = rel_err(got, ref)
            db_got = wm.wave_log_mel(wav, cfg)
            db_ref = power_to_db(ref.transpose(1, 2), ref="max", top_db=80.0)
            db = float((db_got - db_ref).abs().max())
            max_abs = max(max_abs, float((got - ref).abs().max()))
            max_rel, max_db = max(max_rel, rel), max(max_db, db)
            log("k1", profile=profile, case=case, batch=batch, n=n,
                rel_err=f"{rel:.3e}", db_err=f"{db:.3e}")
            db_tol = DB_TOL if cfg.n_mels <= 128 else DB_TOL_MANY_MELS
            if rel > REL_TOL or db > db_tol:
                raise AssertionError(
                    f"K1 {profile}/{case}: kernel disagrees with plain (rel {rel:.3e} > "
                    f"{REL_TOL} or dB {db:.3e} > {db_tol})"
                )
        if profile in K1_WIDE:
            mel, counts = run_counted(lambda: melspectrogram(waves(13, 1).to(dtype), cfg))
            expect_launched(counts, "wave_mel", f"melspectrogram {profile}")
            if mel.shape != (13, cfg.n_mels, n_frames_for(N_SAMPLES, cfg.hop_length, cfg.n_fft, cfg.center)):
                raise AssertionError(f"melspectrogram {profile}: shape {tuple(mel.shape)}")
            log("k1", profile=profile, route=mel_route(cfg, dtype), melspectrogram_launches=counts["wave_mel"])
        if profile not in PROFILES + K1_WIDE:
            continue
        T = n_frames_for(N_SAMPLES, cfg.hop_length, cfg.n_fft, cfg.center)
        wav = waves(BATCH, 2).to(dtype)
        padded = center_pad(wav, cfg.n_fft, cfg.pad_mode).contiguous()
        t = in_turns(lambda: wm.wave_mel(padded, cfg, n_frames=T),
                     lambda: wm.wave_mel_reference(padded, cfg, n_frames=T),
                     stft_chain(padded, cfg))
        bound = mel_bound(cfg, BATCH * T, padded.numel() * padded.element_size())
        flop = 4.0 * BATCH * T * cfg.n_fft * (cfg.n_fft // 2 + 1)
        log("k1", profile=profile, batch=BATCH, kernel_ms=f"{t['ms']:.3f}",
            plain_ms=f"{t['plain_ms']:.3f}", kernel_runs="%.3f,%.3f" % t["runs"],
            plain_runs="%.3f,%.3f" % t["plain_runs"], dft_tflop=f"{flop / 1e12:.3f}",
            kernel_dft_tflops=f"{flop / t['ms'] / 1e9:.2f}", **bound_fields(t, bound))
        results[profile] = {**t, **bound, "max_abs_err": max_abs}
        del wav, padded
        free()
    return results


def phase_k3() -> dict:
    """K3 vs its plain version and K1's direct plain chain at parity."""
    max_abs = 0.0
    # length 32001: the padded rows are 34049 samples, so odd rows start off
    # 8-byte alignment and the launcher takes the 4-byte-load instance
    for case, batch, n in (("random", BATCH, N_SAMPLES), ("ragged", 13, N_SAMPLES),
                           ("silence", 64, N_SAMPLES), ("length32032", 64, 32032),
                           ("length32001", 64, 32001), ("mels128", 13, N_SAMPLES),
                           ("mels256", 13, N_SAMPLES)):
        n_mels = {"mels128": 128, "mels256": 256}.get(case, 64)
        cfg = MelConfig.for_profile("parity", SR, n_mels=n_mels)
        wav = waves(batch, 1, n) if case != "silence" else torch.zeros((batch, n), device=DEVICE)
        T = n_frames_for(n, cfg.hop_length, cfg.n_fft, cfg.center)
        padded = center_pad(wav, cfg.n_fft, cfg.pad_mode).contiguous()
        got = ctm.ct_mel(padded, cfg, n_frames=T)
        torch.cuda.synchronize()
        if got.shape != (batch, T, cfg.n_mels) or not torch.isfinite(got).all():
            raise AssertionError(f"K3 {case}: bad kernel output {tuple(got.shape)}")
        ref = ctm.ct_mel_reference(padded, cfg, n_frames=T)
        rel_ct = rel_err(got, ref)
        max_abs = max(max_abs, float((got - ref).abs().max()))
        del ref
        direct = wm.wave_mel_reference(padded, cfg, n_frames=T)
        rel_direct = rel_err(got, direct)
        db_ref = power_to_db(direct.transpose(1, 2), ref="max", top_db=80.0)
        del direct
        db = float((ctm.ct_log_mel(wav, cfg) - db_ref).abs().max())
        log("k3", case=case, batch=batch, n=n, n_mels=cfg.n_mels,
            rel_err_vs_ct_plain=f"{rel_ct:.3e}", rel_err_vs_direct_plain=f"{rel_direct:.3e}",
            db_err=f"{db:.3e}")
        db_tol = DB_TOL if cfg.n_mels <= 128 else DB_TOL_MANY_MELS
        if max(rel_ct, rel_direct) > REL_TOL or db > db_tol:
            raise AssertionError(
                f"K3 {case}: kernel disagrees with plain (rel {rel_ct:.3e} / {rel_direct:.3e} "
                f"> {REL_TOL} or dB {db:.3e} > {db_tol})"
            )
        del wav, padded, got, db_ref
        free()
    cfg = MelConfig.for_profile("parity", SR)
    wav = waves(BATCH, 2)
    padded = center_pad(wav, cfg.n_fft, cfg.pad_mode).contiguous()
    T = n_frames_for(N_SAMPLES, cfg.hop_length, cfg.n_fft, cfg.center)
    k3 = lambda: ctm.ct_mel(padded, cfg, n_frames=T)  # noqa: E731
    library = stft_chain(padded, cfg)
    lib_rel = rel_err(library(), k3())
    t = in_turns(k3, lambda: ctm.ct_mel_reference(padded, cfg, n_frames=T), library)
    route = in_turns(k3, lambda: wm.wave_mel(padded, cfg, n_frames=T))  # "plain" = K1 here
    bound = mel_bound(cfg, BATCH * T, padded.numel() * 4)
    # the kernel's own flops per frame: window, two passes of 32 radix-2
    # 32-point FFTs (80 butterflies, 34 twiddle products: 524 flops each),
    # the W_1024 twiddle, the real split with |X|^2 (19 a bin), the mel spans
    nnz = int(np.count_nonzero(cfg.filterbank()))
    flop = BATCH * T * (2048 + 2 * 32 * 524 + 6 * 1024 + 19 * 1025 + 2 * nnz)
    log("k3", batch=BATCH, kernel_ms=f"{t['ms']:.3f}", plain_ms=f"{t['plain_ms']:.3f}",
        kernel_runs="%.3f,%.3f" % t["runs"], plain_runs="%.3f,%.3f" % t["plain_runs"],
        kernel_gflop=f"{flop / 1e9:.2f}", kernel_tflops=f"{flop / t['ms'] / 1e9:.2f}",
        library_rel_err=f"{lib_rel:.3e}", **bound_fields(t, bound))
    log("route", profile="parity", batch=BATCH, ct_mel_ms="%.3f,%.3f" % route["runs"],
        wave_mel_ms="%.3f,%.3f" % route["plain_runs"], routed=mel_route(cfg))
    del wav, padded
    free()
    return {**t, **bound, "max_abs_err": max_abs, "k1_ms": route["plain_ms"]}


def phase_k2() -> dict:
    """K2 vs plain in f32 and bf16, both profiles; then its drop-in path."""
    results = {}
    for profile in PROFILES:
        cfg = MelConfig.for_profile(profile, SR)
        frames = frame_signal(waves(BATCH, 3), n_fft=cfg.n_fft, hop_length=cfg.hop_length)
        frames = frames.reshape(-1, cfg.n_fft).contiguous()
        n_full = frames.shape[0]
        max_abs = 0.0
        for case, x in (("frames", frames), ("ragged", frames[:100])):
            outs = {}
            for dt in ("float32", "bfloat16"):
                got = flm.fused_mel_from_frames(x, cfg, compute_dtype=dt)
                torch.cuda.synchronize()
                if got.shape != (len(x), cfg.n_mels) or not torch.isfinite(got).all():
                    raise AssertionError(f"K2 {profile}/{case}/{dt}: bad kernel output")
                ref = flm.fused_mel_from_frames_reference(x, cfg, compute_dtype=dt)
                rel = rel_err(got, ref)
                if dt == "float32":
                    max_abs = max(max_abs, float((got - ref).abs().max()))
                outs[dt] = got
                log("k2", profile=profile, case=case, n=len(x), dtype=dt, rel_err=f"{rel:.3e}")
                if rel > REL_TOL:
                    raise AssertionError(f"K2 {profile}/{case}/{dt}: rel err {rel:.3e} > {REL_TOL}")
                del ref
            f32 = outs["float32"]
            med = float(((outs["bfloat16"] - f32).abs() / f32.abs().clamp_min(1e-3)).median())
            log("k2", profile=profile, case=case, bf16_vs_f32_median_rel=f"{med:.3e}")
            if med > BF16_MEDIAN_TOL:
                raise AssertionError(f"K2 {profile}/{case}: bf16 median rel err {med:.3e}")
            del outs, f32
            free()
        # the wrapper takes f32 frames in both compute types (it casts them)
        bound = mel_bound(cfg, n_full, frames.numel() * 4)
        for dt in ("float32", "bfloat16"):
            t = in_turns(lambda: flm.fused_mel_from_frames(frames, cfg, compute_dtype=dt),
                         lambda: flm.fused_mel_from_frames_reference(frames, cfg, compute_dtype=dt),
                         rfft_chain(frames, cfg))
            log("k2", profile=profile, n=n_full, dtype=dt, kernel_ms=f"{t['ms']:.3f}",
                plain_ms=f"{t['plain_ms']:.3f}", kernel_runs="%.3f,%.3f" % t["runs"],
                plain_runs="%.3f,%.3f" % t["plain_runs"], **bound_fields(t, bound))
            results[(profile, dt)] = {**t, **bound, "max_abs_err": max_abs}
        del frames
        free()

    # 128 mels (the 128-column mel accumulator), and n_fft 100 from a view
    # one float off 16-byte alignment (4-byte copies in f32; bf16 rows of
    # 100 are copied to aligned rows of 104)
    for name, cfg, shift in (("mels128", MelConfig.for_speech(SR, n_mels=128), 0),
                             ("n_fft100", MelConfig(sr=SR, n_fft=100, hop_length=50, n_mels=16), 1)):
        flat = frame_signal(waves(13, 3), n_fft=cfg.n_fft, hop_length=cfg.hop_length).reshape(-1)
        n = flat.numel() // cfg.n_fft - 1
        frames = flat[shift : shift + n * cfg.n_fft].view(n, cfg.n_fft)
        for dt in ("float32", "bfloat16"):
            got = flm.fused_mel_from_frames(frames, cfg, compute_dtype=dt)
            rel = rel_err(got, flm.fused_mel_from_frames_reference(frames, cfg, compute_dtype=dt))
            log("k2", profile=name, n=n, dtype=dt, rel_err=f"{rel:.3e}")
            if got.shape != (n, cfg.n_mels) or rel > REL_TOL:
                raise AssertionError(f"K2 {name}/{dt}: rel err {rel:.3e} > {REL_TOL}")

    # the drop-in path: fused_log_mel_spectrogram at B=8192, both dtypes
    cfg = MelConfig.for_profile("parity", SR)
    wav = waves(BATCH, 4)
    T = n_frames_for(N_SAMPLES, cfg.hop_length, cfg.n_fft, cfg.center)
    padded = center_pad(wav, cfg.n_fft, cfg.pad_mode).contiguous()
    db_plain = power_to_db(wm.wave_mel_reference(padded, cfg, n_frames=T).transpose(1, 2),
                           ref="max", top_db=80.0)
    del padded
    launches = 0
    for dt in ("float32", "bfloat16"):
        out, counts = run_counted(lambda: flm.fused_log_mel_spectrogram(wav, cfg, compute_dtype=dt))
        launches += expect_launched(counts, "fused_mel_from_frames", f"K2 drop-in {dt}")
        if out.shape != (BATCH, cfg.n_mels, T) or not torch.isfinite(out).all():
            raise AssertionError(f"K2 drop-in {dt}: bad output {tuple(out.shape)}")
        frames = frame_signal(wav, n_fft=cfg.n_fft, hop_length=cfg.hop_length).reshape(-1, cfg.n_fft)
        mel = flm.fused_mel_from_frames_reference(frames, cfg, compute_dtype=dt)
        db_ref = power_to_db(mel.reshape(BATCH, T, -1).transpose(1, 2), ref="max", top_db=80.0)
        db = float((out - db_ref).abs().max())
        db_vs_f32_plain = float((out - db_plain).abs().median())
        log("k2-path", dtype=dt, batch=BATCH, launches=counts["fused_mel_from_frames"],
            db_err_vs_plain_same_dtype=f"{db:.3e}", median_db_vs_f32_plain=f"{db_vs_f32_plain:.3e}")
        if db > DB_TOL:
            raise AssertionError(f"K2 drop-in {dt}: dB err {db:.3e} > {DB_TOL}")
        del out, frames, mel, db_ref
        free()
    results["launches"] = launches
    return results


def numpy_mel64(wav: np.ndarray, cfg: MelConfig) -> np.ndarray:
    """Independent float64 mel power: numpy rfft of reflect-padded frames."""
    pad = cfg.n_fft // 2
    y = np.pad(wav.astype(np.float64), ((0, 0), (pad, pad)), mode="reflect")
    T = 1 + (y.shape[1] - cfg.n_fft) // cfg.hop_length
    idx = np.arange(T)[:, None] * cfg.hop_length + np.arange(cfg.n_fft)[None, :]
    spec = np.fft.rfft(y[:, idx] * _window_array(cfg.window, cfg.n_fft, cfg.n_fft), axis=-1)
    return np.einsum("mf,btf->bmt", cfg.filterbank(), np.abs(spec) ** 2)


def phase_e2e() -> tuple[dict, dict]:
    """The scorer in both profiles; returns (launches by kernel, utt/s)."""
    launches, rates = {}, {}
    for profile in PROFILES:
        cfg = MelConfig.for_profile(profile, SR)
        kernel = mel_route(cfg)
        T = n_frames_for(N_SAMPLES, cfg.hop_length, cfg.n_fft, cfg.center)
        model = CNNBiLSTMHybrid(T)
        model.load_state_dict(flax_to_torch_cnn_bilstm(random_flax_cnn_bilstm(0, T)))
        model = model.to(DEVICE).eval()
        score = make_mel_cnn_bilstm_scorer(model, cfg)

        small = np.random.default_rng(3).standard_normal((4, N_SAMPLES)).astype(np.float32) * 0.1
        feats = melspectrogram(torch.from_numpy(small).to(DEVICE), cfg).double().cpu().numpy()
        ref64 = numpy_mel64(small, cfg)
        small_rel = float((np.abs(feats - ref64) / ref64.max(axis=(1, 2), keepdims=True)).max())
        if small_rel > REL_TOL:
            raise AssertionError(f"{profile}: mel vs float64 numpy rel err {small_rel:.3e}")

        wav = waves(BATCH, 4)
        scores, counts = run_counted(lambda: score(wav))
        n = expect_launched(counts, kernel, f"e2e {profile}")
        launches[kernel] = launches.get(kernel, 0) + n
        if scores.shape != (BATCH,) or not bool(((scores > 0) & (scores < 1)).all()):
            raise AssertionError(f"{profile}: scores not finite in (0, 1)")
        with torch.inference_mode():
            padded = center_pad(wav, cfg.n_fft, cfg.pad_mode).contiguous()
            mel = wm.wave_mel_reference(padded, cfg, n_frames=T).transpose(1, 2)
            plain = model(power_to_db(mel, ref="max", top_db=80.0)).reshape(-1)
        diff = float((scores - plain).abs().max())
        if diff > SCORE_TOL:
            raise AssertionError(f"{profile}: scores differ from the plain mel path by {diff:.3e}")
        ms = cuda_ms(lambda: score(wav), 3)
        rates[profile] = BATCH / ms * 1e3
        log("e2e", profile=profile, batch=BATCH, kernel=kernel, launches=n,
            score_diff_vs_plain=f"{diff:.3e}", mel_vs_numpy64=f"{small_rel:.3e}",
            score_range=f"{float(scores.min()):.4f}..{float(scores.max()):.4f}",
            ms=f"{ms:.3f}", utt_per_s=f"{rates[profile]:.1f}")
        wall, busy, ranked = device_breakdown(lambda: score(wav))
        log("breakdown", profile=profile, host_wall_ms=f"{wall:.3f}",
            device_kernel_ms=f"{busy:.3f}", busy_share=f"{busy / wall:.3f}")
        for k_ms, k_n, name in ranked:
            print(f"  {k_ms:8.3f} ms  x{k_n}  {name[:100]}", flush=True)
        del wav, padded, mel, plain, model
        free()
    return launches, rates


def _post(url: str, body: bytes, headers: dict) -> tuple[int, dict]:
    req = urllib.request.Request(url, data=body, headers=headers, method="POST")
    with urllib.request.urlopen(req, timeout=120) as resp:
        return resp.status, json.loads(resp.read())


def _encoded(y: np.ndarray, fmt: str) -> tuple[bytes, np.ndarray]:
    """(file bytes, the row the service decodes from them) for one utterance."""
    from audioanalysisdetector_tpu_torch.io.audio import load_audio

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, f"u.{fmt}")
        if fmt == "wav":
            write_wav(path, y, SR)
        else:
            write_flac(path, np.round(np.clip(y, -0.999, 0.999) * 32767).astype(np.int64), SR)
        decoded, _ = load_audio(path, sr=SR)
        return Path(path).read_bytes(), decoded


def random_checkpoint(directory: str, cfg: MelConfig) -> str:
    """A state_dict of random weights, the LayerNorm and BatchNorm included,
    saved where ``--checkpoint`` reads it: with the default init the
    LayerNorm(1) quirk zeroes the attention and every score is the same, so
    a comparison of scores would show nothing."""
    T = n_frames_for(N_SAMPLES, cfg.hop_length, cfg.n_fft, cfg.center)
    path = os.path.join(directory, "random_cnn_bilstm.pt")
    torch.save(flax_to_torch_cnn_bilstm(random_flax_cnn_bilstm(0, T)), path)
    return path


def phase_serve() -> dict:
    """8 concurrent PCM requests, then audio_b64 WAV and FLAC; returns launches."""
    cfg = MelConfig.for_profile("parity", SR)
    kernel = mel_route(cfg)
    with tempfile.TemporaryDirectory() as d:
        scorer, n_samples = build_mel_scorer(
            checkpoint=random_checkpoint(d, cfg), sr=SR, seconds=N_SAMPLES / SR, device=DEVICE
        )
    batcher = BatchingScorer(
        scorer, n_samples=n_samples, max_batch=256, bucket_sizes=default_bucket_ladder(256)
    )
    batcher.warm_up()
    server = ScoreServer(batcher, sr=SR, host="127.0.0.1", port=0)
    server.start_background()
    try:
        base = f"http://127.0.0.1:{server.port}"
        json_hdr = {"Content-Type": "application/json"}
        rng = np.random.default_rng(5)
        rows = [(rng.standard_normal((1 + 2 * i, n_samples)) * 0.1).astype(np.float32) for i in range(8)]
        results: list = [None] * 8

        def send(i: int) -> None:
            data = rows[i].astype("<f4").tobytes()
            if i % 2 == 0:
                body = json.dumps({"pcm_b64": base64.b64encode(data).decode(), "rows": len(rows[i])})
                results[i] = _post(f"{base}/v1/score", body.encode(), json_hdr)
            else:
                results[i] = _post(f"{base}/v1/score_raw", data, {
                    "Content-Type": "application/octet-stream", "X-Rows": str(len(rows[i]))})

        def send_all() -> list:
            threads = [threading.Thread(target=send, args=(i,)) for i in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
            return threads

        threads, counts = run_counted(send_all)
        n = expect_launched(counts, kernel, "serve")
        if any(t.is_alive() for t in threads) or any(r is None for r in results):
            raise AssertionError("a serving request did not complete")
        worst = 0.0
        for i, (status, payload) in enumerate(results):
            if status != 200:
                raise AssertionError(f"request {i}: HTTP {status}")
            worst = max(worst, float(np.abs(np.asarray(payload["scores"]) - scorer(rows[i])).max()))

        # audio_b64: one WAV and one FLAC upload, decoded by the service
        y = (rng.standard_normal(n_samples) * 0.1).astype(np.float32)
        for fmt in ("wav", "flac"):
            data, decoded = _encoded(y, fmt)
            body = json.dumps({"audio_b64": base64.b64encode(data).decode(), "format": fmt})
            (status, payload), c = run_counted(lambda: _post(f"{base}/v1/score", body.encode(), json_hdr))
            n += expect_launched(c, kernel, f"serve audio_b64 {fmt}")
            if status != 200:
                raise AssertionError(f"audio_b64 {fmt}: HTTP {status}")
            diff = float(np.abs(np.asarray(payload["scores"]) - scorer(decoded[None, :n_samples])).max())
            worst = max(worst, diff)
            log("serve", lane=f"audio_b64/{fmt}", score=f"{payload['scores'][0]:.6f}",
                diff_vs_direct=f"{diff:.3e}")
        if worst > SERVE_TOL:
            raise AssertionError(f"served scores differ from the direct scorer by {worst:.3e}")
        with urllib.request.urlopen(f"{base}/healthz", timeout=30) as resp:
            health = json.loads(resp.read())
        if health["platform"] != DEVICE:
            raise AssertionError(f"/healthz says {health['platform']!r}, not {DEVICE!r}")
        log("serve", requests=10, rows=sum(len(r) for r in rows) + 2, kernel=kernel, launches=n,
            max_diff_vs_direct=f"{worst:.3e}", healthz=health["platform"],
            stats=json.dumps(batcher.stats.snapshot(), separators=(",", ":")))
    finally:
        server.close()
    return {kernel: n}


def phase_score() -> dict:
    """The ``score`` CLI over 64 files in a subprocess; returns its launches."""
    cfg = MelConfig.for_profile("parity", SR)
    kernel = mel_route(cfg)
    rng = np.random.default_rng(6)
    with tempfile.TemporaryDirectory() as d:
        ckpt = random_checkpoint(d, cfg)
        audio = os.path.join(d, "audio")
        os.mkdir(audio)
        for i in range(32):
            y = np.clip(rng.standard_normal(N_SAMPLES) * 0.1, -0.999, 0.999)
            write_wav(os.path.join(audio, f"u{i:02d}.wav"), y, SR)
            write_flac(os.path.join(audio, f"v{i:02d}.flac"), np.round(y * 32767).astype(np.int64), SR)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "audioanalysisdetector_tpu_torch", "score", audio,
             "--checkpoint", ckpt, "--device", DEVICE],
            capture_output=True, text=True, timeout=600, cwd=ROOT,
        )
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"score CLI exited {proc.returncode}:\n{proc.stderr[-4000:]}")
        lines = [json.loads(line) for line in proc.stdout.splitlines() if line.strip()]
        counts = next(
            json.loads(line)["kernel_launches"] for line in proc.stderr.splitlines()
            if line.startswith('{"kernel_launches"')
        )
        n = expect_launched(counts, kernel, "score CLI")
        files = [line["file"] for line in lines]
        if len(lines) != 64 or len(set(files)) != 64:
            raise AssertionError(f"score CLI printed {len(lines)} lines for 64 files")
        got = np.asarray([line["spoof_score"] for line in lines])
        if not ((got > 0) & (got < 1)).all():
            raise AssertionError("score CLI: scores not in (0, 1)")
        rows = load_chunk_batch_native(files, [0.0] * 64, [N_SAMPLES / SR] * 64, sr=SR)
        model = init_mel_cnn_bilstm(cfg, N_SAMPLES, checkpoint=ckpt, device=DEVICE)
    direct = make_mel_cnn_bilstm_scorer(model, cfg)(torch.from_numpy(rows).to(DEVICE)).cpu().numpy()
    diff = float(np.abs(got - direct).max())
    log("score", files=64, kernel=kernel, launches=n, native_decoder=native_available(),
        max_diff_vs_direct=f"{diff:.3e}", score_range=f"{got.min():.4f}..{got.max():.4f}",
        wall_s=f"{wall:.1f}")
    if diff > SERVE_TOL:
        raise AssertionError(f"score CLI differs from the direct scorer by {diff:.3e}")
    return {kernel: n}


def fused_models(device: str, dim: int = 19):
    """The fused system at full width from numpy seeds: BiLSTMClassifier
    (hidden 128) and two 128-component diagonal GMMs over ``dim`` features."""
    model = BiLSTMClassifier(hidden=128, input_dim=19)
    model.load_state_dict(flax_to_torch_bilstm_classifier(random_flax_bilstm_classifier(0, 128, 19)))
    g = from_numpy(random_diag_gmm(1, 128, dim), device=device)
    s = from_numpy(random_diag_gmm(2, 128, dim), device=device)
    return model.to(device).eval(), g, s


def fused_flop(cfg: CQCCConfig, batch: int, n: int, hidden: int = 128, k: int = 128) -> dict:
    """Floating-point operations of one fused batch by stage, from the
    shapes the port multiplies (the banded operators' zeros included: they
    are what cuBLAS computes): the CQT's framing GEMMs and dense
    operators, its decimation GEMMs, CQCC's regrid and DCT, the two BiLSTM
    layers (both directions over all T steps), the two GMMs' two GEMMs."""
    from audioanalysisdetector_tpu_torch.frontend.cqt import _decim_block_for, _octave_kernel_bank

    c = cfg.cqt
    T = 1 + n // c.hop_length
    cqt_ops = decim = 0.0
    n_cur = n + (-n) % 2 ** (c.n_octaves - 1)
    for octave in range(c.n_octaves):
        kernels, K = _octave_kernel_bank(c, octave)
        hop = c.hop_length >> octave
        if -(-K // hop) <= 2:
            cqt_ops += 2.0 * batch * T * K * kernels.shape[0]
        else:
            cqt_ops += 2.0 * batch * n_cur * T * kernels.shape[0]
        if octave + 1 < c.n_octaves:
            block = _decim_block_for(n_cur) or 256
            decim += 2.0 * batch * -(-n_cur // block) * (block + 62) * (block // 2)
            n_cur //= 2
    cqcc_ops = 2.0 * batch * T * c.n_bins * (c.n_bins + cfg.n_ceps)
    lstm = sum(2 * 2.0 * batch * T * 4 * hidden * (i + hidden) for i in (cfg.n_ceps, 2 * hidden))
    gmm = 2 * 2 * 2.0 * batch * T * cfg.n_ceps * k
    return {"cqt": cqt_ops, "decimation": decim, "cqcc": cqcc_ops, "lstm": lstm, "gmm": gmm}


def phase_fused() -> dict:
    """The flagship wav -> CQCC -> GMM ⊕ BiLSTM scorer at B=8192; returns
    its numbers."""
    cfg = CQCCConfig()
    model, g, s = fused_models(DEVICE)
    # the scaler: fitted on the CQCC frames of 256 utterances made from a numpy seed
    seed_rows = np.random.default_rng(12).standard_normal((256, N_SAMPLES)).astype(np.float32) * 0.1
    with torch.inference_mode():
        frames = transpose_cqcc(cqcc(torch.from_numpy(seed_rows).to(DEVICE), cfg)).cpu().numpy()
    scaler = FrameScaler.fit_sequences(frames)
    score = make_cqcc_fused_scorer(model, g, s, cfg, scaler_mean=scaler.mean, scaler_std=scaler.std)

    wav = waves(BATCH, 7)
    scores, counts = run_counted(lambda: score(wav))
    if scores.shape != (BATCH,) or not bool(((scores > 0) & (scores < 1)).all()):
        raise AssertionError("fused: scores not finite in (0, 1)")
    model_c, g_c, s_c = fused_models("cpu")
    cpu = make_cqcc_fused_scorer(model_c, g_c, s_c, cfg, scaler_mean=scaler.mean, scaler_std=scaler.std)
    diff = float((scores[:256].cpu() - cpu(wav[:256].cpu())).abs().max())
    if diff > FUSED_TOL:
        raise AssertionError(f"fused: card scores differ from the CPU's by {diff:.3e} > {FUSED_TOL}")
    ms = cuda_ms(lambda: score(wav), 3)
    flop = fused_flop(cfg, BATCH, N_SAMPLES)
    log("fused", batch=BATCH, **{f"gflop_{k}": f"{v / 1e9:.1f}" for k, v in flop.items()},
        tflops=f"{sum(flop.values()) / ms / 1e9:.2f}")
    log("fused", batch=BATCH, cqcc=f"{cfg.cqt.n_bins}bins/hop{cfg.cqt.hop_length}/{cfg.n_ceps}ceps",
        gmm_components=g.n_components, bilstm_hidden=128, kernel_launches=json.dumps(counts, separators=(",", ":")),
        diff_vs_cpu_256=f"{diff:.3e}", score_range=f"{float(scores.min()):.4f}..{float(scores.max()):.4f}",
        ms=f"{ms:.3f}", utt_per_s=f"{BATCH / ms * 1e3:.1f}")
    wall, busy, ranked = device_breakdown(lambda: score(wav))
    log("breakdown", path="fused", host_wall_ms=f"{wall:.3f}", device_kernel_ms=f"{busy:.3f}",
        busy_share=f"{busy / wall:.3f}")
    for k_ms, k_n, name in ranked:
        print(f"  {k_ms:8.3f} ms  x{k_n}  {name[:100]}", flush=True)

    # the GMM arm on deltas + CMVN frames: D = 57 GMMs through make_fused_scorer
    with torch.inference_mode():
        feats = scaler.transform(transpose_cqcc(cqcc(wav, cfg)))
    fn = make_gmm_feature_fn(deltas=True, cmvn=True)
    _, g57, s57 = fused_models(DEVICE, dim=57)
    _, g57_c, s57_c = fused_models("cpu", dim=57)
    scores57 = make_fused_scorer(model, g57, s57, gmm_feature_fn=fn)(feats)
    cpu57 = make_fused_scorer(model_c, g57_c, s57_c, gmm_feature_fn=fn)(feats[:256].cpu())
    diff57 = float((scores57[:256].cpu() - cpu57).abs().max())
    ms57 = cuda_ms(lambda: make_fused_scorer(model, g57, s57, gmm_feature_fn=fn)(feats), 3)
    log("fused", transform="deltas+cmvn", gmm_dim=57, batch=BATCH, diff_vs_cpu_256=f"{diff57:.3e}",
        ms_from_features=f"{ms57:.3f}")
    if not bool(((scores57 > 0) & (scores57 < 1)).all()) or diff57 > FUSED_TOL:
        raise AssertionError(f"fused deltas+cmvn: scores out of (0, 1) or {diff57:.3e} from the CPU's")

    # eval_model over a model dir written with to_numpy: card and CPU agree.
    # Its spoof GMM is the genuine one with moved means, so the LLRs sit
    # around 0 and the 0.5 threshold splits the rows
    x = feats[:512].cpu().numpy()
    rng = np.random.default_rng(13)
    y = rng.integers(0, 2, 512)
    near = random_diag_gmm(1, 128, 19)
    near["means"] = near["means"] + 0.1 * rng.standard_normal(near["means"].shape).astype(np.float32)
    with tempfile.TemporaryDirectory() as d:
        for name, gmm in (("ubm", g), ("gmm_genuine", g), ("gmm_df", from_numpy(near, device="cpu"))):
            np.savez(os.path.join(d, f"{name}.npz"), **to_numpy(gmm))
        card = eval_model(model, None, None, x, y, model_dir=d, verbose=False, device=DEVICE)
        host = eval_model(model_c, None, None, x, y, model_dir=d, verbose=False, device="cpu")
    same = bool((card[1] == host[1]).all())
    log("fused", eval_model_rows=512, predicted_spoof=int(card[1].sum()), accuracy=card[2]["accuracy"],
        f1=f"{card[2]['f1']:.6f}", eer=card[2]["eer"], cpu_eer=host[2]["eer"], same_y_pred=same)
    if not same or abs(card[2]["eer"] - host[2]["eer"]) > 1e-6 or not 0 < card[1].sum() < 512:
        raise AssertionError(f"eval_model: card {card[2]} and CPU {host[2]} differ")
    del wav, feats, scores, scores57
    free()
    return {"ms": ms, "utt_per_s": BATCH / ms * 1e3, "diff_vs_cpu": diff}


def train_corpus(n: int, seed: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(wav (n, N_SAMPLES), labels (n,)) made on the card from a seed:
    bonafide rows are noise; spoof rows are noise plus a tone of seeded
    frequency (300-3000 Hz), so the classes separate."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    y = torch.randint(0, 2, (n,), generator=g, device=DEVICE)
    wav = 0.1 * torch.randn((n, N_SAMPLES), generator=g, device=DEVICE)
    f0 = 300.0 + 2700.0 * torch.rand((n, 1), generator=g, device=DEVICE)
    t = torch.arange(N_SAMPLES, device=DEVICE) / SR
    return wav + 0.1 * y[:, None] * torch.sin(2 * np.pi * f0 * t), y


def steps_card_vs_cpu(model_fn, x: torch.Tensor, y: torch.Tensor, loss: str, binary: bool, n: int):
    """``n`` train steps (Adam 1e-4) of one model on the card and on the CPU
    from the same weights on the same batches of TRAIN_BATCH rows: (card
    losses, CPU losses, card state, CPU state)."""
    out = []
    for device in (DEVICE, "cpu"):
        state = TrainState.create(model=model_fn().to(device), tx=make_optimizer("Adam", 1e-4))
        step = make_train_step(get_loss(loss), has_batch_stats=state.has_batch_stats, binary_head=binary)
        g = torch.Generator(device=device).manual_seed(0)
        losses = []
        for i in range(n):
            rows = slice(i * TRAIN_BATCH, (i + 1) * TRAIN_BATCH)
            state, m = step(state, x[rows].to(device), y[rows].to(device), g)
            losses.append(float(m["loss"]))
        out.append((np.asarray(losses), state))
    return out[0][0], out[1][0], out[0][1], out[1][1]


def step_timing(label: str, model_fn, x: torch.Tensor, y: torch.Tensor, loss: str, binary: bool) -> dict:
    """ms per train step (CUDA events over 20 steps after 3 warm-up ones) at
    batch 256 and 16, train utt/s, and a ``device_breakdown`` of one step."""
    out = {}
    for batch in (TRAIN_BATCH, 16):
        state = TrainState.create(model=model_fn().to(DEVICE), tx=make_optimizer("Adam", 1e-4))
        step = make_train_step(get_loss(loss), has_batch_stats=state.has_batch_stats, binary_head=binary)
        g = torch.Generator(device=DEVICE).manual_seed(0)
        xb, yb = x[:batch].contiguous(), y[:batch].contiguous()
        for _ in range(3):
            step(state, xb, yb, g)
        ms = cuda_ms(lambda: step(state, xb, yb, g), 20)
        wall, busy, ranked = device_breakdown(lambda: step(state, xb, yb, g))
        log("train-step", model=label, batch=batch, ms=f"{ms:.3f}", utt_per_s=f"{batch / ms * 1e3:.1f}",
            host_wall_ms=f"{wall:.3f}", device_kernel_ms=f"{busy:.3f}", busy_share=f"{busy / wall:.3f}")
        for k_ms, k_n, name in ranked:
            print(f"  {k_ms:8.3f} ms  x{k_n}  {name[:100]}", flush=True)
        print("  host, self CPU time per step:", flush=True)
        for h_ms, h_n, name in host_ops(lambda: step(state, xb, yb, g)):
            print(f"  {h_ms:8.3f} ms  x{h_n}  {name[:100]}", flush=True)
        out[batch] = {"ms": ms, "busy_share": busy / wall}
    return out


def train_cli(d: str, cfg: MelConfig) -> int:
    """``train`` over 64 WAVs in a subprocess on the card, then ``score`` of
    its best_model.msgpack against the direct scorer; returns the K3
    launches of both subprocesses."""
    rng = np.random.default_rng(14)
    t = np.arange(N_SAMPLES) / SR
    audio = os.path.join(d, "corpus")
    for label in ("bonafide", "spoof"):
        os.makedirs(os.path.join(audio, label))
        for i in range(32):
            y = rng.standard_normal(N_SAMPLES) * 0.1
            if label == "spoof":
                y = y + 0.1 * np.sin(2 * np.pi * rng.uniform(300, 3000) * t)
            write_wav(os.path.join(audio, label, f"u{i:02d}.wav"), np.clip(y, -0.999, 0.999), SR)
    run = os.path.join(d, "run")
    launches = 0
    for argv in (["train", audio, "--epochs", "1", "--run-dir", run, "--device", DEVICE],
                 ["score", audio, "--checkpoint", os.path.join(run, "best_model.msgpack"), "--device", DEVICE]):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "audioanalysisdetector_tpu_torch", *argv],
                              capture_output=True, text=True, timeout=600, cwd=ROOT)
        if proc.returncode != 0:
            raise AssertionError(f"{argv[0]} CLI exited {proc.returncode}:\n{proc.stderr[-4000:]}")
        counts = next(json.loads(line)["kernel_launches"] for line in proc.stderr.splitlines()
                      if line.startswith('{"kernel_launches"'))
        launches += expect_launched(counts, mel_route(cfg), f"{argv[0]} CLI")
        lines = [json.loads(line) for line in proc.stdout.splitlines() if line.strip().startswith("{")]
        log("train-cli", command=argv[0], wall_s=f"{time.perf_counter() - t0:.1f}", launches=counts[mel_route(cfg)],
            last_line=json.dumps(lines[-1], separators=(",", ":")))
    files = [line["file"] for line in lines]
    got = np.asarray([line["spoof_score"] for line in lines])
    if len(set(files)) != 64 or not ((got > 0) & (got < 1)).all():
        raise AssertionError(f"score CLI on the trained run: {len(set(files))} files, scores {got.min()}..{got.max()}")
    rows = load_chunk_batch_native(files, [0.0] * 64, [N_SAMPLES / SR] * 64, sr=SR)
    model = init_mel_cnn_bilstm(cfg, N_SAMPLES, checkpoint=os.path.join(run, "best_model.msgpack"), device=DEVICE)
    direct = make_mel_cnn_bilstm_scorer(model, cfg)(torch.from_numpy(rows).to(DEVICE)).cpu().numpy()
    diff = float(np.abs(got - direct).max())
    log("train-cli", files=64, score_diff_vs_direct=f"{diff:.3e}", run_files=",".join(sorted(os.listdir(run))))
    if diff > SERVE_TOL:
        raise AssertionError(f"score CLI on the trained run differs from the direct scorer by {diff:.3e}")
    return launches


def grad_guard() -> None:
    """Each mel kernel refuses a CUDA input that requires grad, and counts no launch."""
    parity, speech = MelConfig.for_profile("parity", SR), MelConfig.for_profile("speech", SR)
    wav = waves(2, 1).requires_grad_()
    frames = frame_signal(waves(2, 1), n_fft=speech.n_fft, hop_length=speech.hop_length)
    cases = (("ct_mel", lambda: melspectrogram(wav, parity)),
             ("wave_mel", lambda: melspectrogram(wav, speech)),
             ("fused_mel_from_frames", lambda: flm.fused_mel_from_frames(
                 frames.reshape(-1, speech.n_fft).requires_grad_(), speech)))
    for kernel, call in cases:
        reset_launch_counts()
        try:
            call()
        except RuntimeError as e:
            if "no backward" not in str(e):
                raise
        else:
            raise AssertionError(f"{kernel} took an input that requires grad")
        if launch_counts()[kernel]:
            raise AssertionError(f"{kernel} counted a launch it refused")
        log("grad-guard", kernel=kernel, refused=True)


def phase_train() -> dict:
    """The training path on the card; returns K3's launches and the numbers."""
    import importlib.util

    cfg = MelConfig.for_profile("parity", SR)
    T = n_frames_for(N_SAMPLES, cfg.hop_length, cfg.n_fft, cfg.center)
    wav, y = train_corpus(TRAIN_ROWS, 15)

    def features():
        with torch.no_grad():
            return log_mel_spectrogram(wav, cfg)

    feats, counts = run_counted(features)
    launches = expect_launched(counts, mel_route(cfg), "train features")
    if feats.shape != (TRAIN_ROWS, cfg.n_mels, T) or not bool(torch.isfinite(feats).all()):
        raise AssertionError(f"train features: bad shape {tuple(feats.shape)} or non-finite values")
    log("train", rows=TRAIN_ROWS, features=tuple(feats.shape), kernel=mel_route(cfg), launches=launches,
        spoof_share=f"{float(y.float().mean()):.4f}",
        matplotlib=importlib.util.find_spec("matplotlib") is not None)

    # card vs CPU: the full-width model from one converted init, dropout 0
    def converted():
        m = CNNBiLSTMHybrid(T, logits=True, dropout_rate=0.0, conv_dropout=0.0)
        m.load_state_dict(flax_to_torch_cnn_bilstm(random_flax_cnn_bilstm(0, T)))
        return m

    card, host, sc, sh = steps_card_vs_cpu(converted, feats, y, "BCELoss", True, 5)
    loss_rel = float(np.abs(card - host).max() / np.abs(host).max())
    bn = [float((getattr(sc.model.bn, k).cpu() - getattr(sh.model.bn, k)).abs().max()
                / getattr(sh.model.bn, k).abs().max()) for k in ("running_mean", "running_var")]
    log("train", check="card_vs_cpu", steps=5, batch=TRAIN_BATCH, losses=",".join(f"{v:.6f}" for v in card),
        loss_rel_diff=f"{loss_rel:.3e}", bn_mean_rel_diff=f"{bn[0]:.3e}", bn_var_rel_diff=f"{bn[1]:.3e}")
    if loss_rel > TRAIN_LOSS_RTOL or max(bn) > TRAIN_BN_RTOL:
        raise AssertionError(f"train steps: card vs CPU loss {loss_rel:.3e} or BN {bn} past the band")
    del sc, sh

    # fit: the full-width model (softmax attention: with the LayerNorm(1)
    # quirk and the flax init every ReLU after the pooling sits at 0, so no
    # gradient reaches the network), flax-like init from seed 0
    def fresh():
        return flax_init_(CNNBiLSTMHybrid(T, logits=True, fixed_attention=True), torch.Generator().manual_seed(0))

    split = int(TRAIN_ROWS * 0.8)
    state = TrainState.create(model=fresh().to(DEVICE), tx=make_optimizer("Adam", 1e-4))
    with tempfile.TemporaryDirectory() as d:
        result = fit(state, (feats[:split], y[:split]), (feats[split:], y[split:]), loss_name="BCELoss",
                     num_epochs=2, batch_size=TRAIN_BATCH, binary_head=True, run_dir=d)
        run_files = sorted(os.listdir(d))
    for row in result.logs:
        log("train-fit", epoch=row.epoch, train_loss=f"{row.train_loss:.6f}", train_acc=f"{row.train_acc:.4f}",
            val_loss=f"{row.val_loss:.6f}", val_acc=f"{row.val_acc:.4f}", seconds=f"{row.seconds:.3f}",
            epoch_utt_per_s=f"{split / row.seconds:.1f}")
    log("train-fit", best_epoch=result.best_epoch, steps=result.state.step, run_files=",".join(run_files))
    first, last = result.logs[0].train_loss, result.logs[-1].train_loss
    if not last < first:
        raise AssertionError(f"fit: train loss did not fall ({first:.6f} -> {last:.6f})")
    timing = step_timing("cnn_bilstm", fresh, feats, y, "BCELoss", True)

    # bilstm_pipeline on the phase's CQCC features (T = 63, F = 19)
    n_cq = 2048
    with torch.no_grad():
        cq = transpose_cqcc(cqcc(wav[:n_cq], CQCCConfig()))
    cq = FrameScaler.fit_sequences(cq.cpu().numpy()).transform(cq).contiguous()
    cut = int(n_cq * 0.8)
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        res, final = bilstm_pipeline((cq[:cut], y[:cut]), (cq[cut:], y[cut:n_cq]), num_epochs=1,
                                     batch_size=TRAIN_BATCH, hidden=128, model_dir=d, device=DEVICE)
        wall = time.perf_counter() - t0
    log("train-bilstm", rows=n_cq, features=tuple(cq.shape), wall_s=f"{wall:.2f}",
        train_loss=f"{res.logs[0].train_loss:.6f}", val_loss=f"{res.logs[0].val_loss:.6f}",
        accuracy=f"{final['accuracy']:.4f}", eer=f"{final['eer']:.4f}")

    def classifier():
        m = BiLSTMClassifier(hidden=128, input_dim=19, dropout=0.0)
        m.load_state_dict(flax_to_torch_bilstm_classifier(random_flax_bilstm_classifier(0, 128, 19)))
        return m

    card, host, *_ = steps_card_vs_cpu(classifier, cq, y, "CrossEntropyLoss", False, 3)
    bl_rel = float(np.abs(card - host).max() / np.abs(host).max())
    log("train-bilstm", check="card_vs_cpu", steps=3, losses=",".join(f"{v:.6f}" for v in card),
        loss_rel_diff=f"{bl_rel:.3e}")
    if bl_rel > TRAIN_LOSS_RTOL:
        raise AssertionError(f"bilstm train steps: card vs CPU loss {bl_rel:.3e} > {TRAIN_LOSS_RTOL}")
    bl_timing = step_timing("bilstm_classifier", classifier, cq, y, "CrossEntropyLoss", False)

    with tempfile.TemporaryDirectory() as d:
        launches += train_cli(d, cfg)
    grad_guard()
    del wav, feats, cq
    free()
    return {"ct_mel": launches, "step": timing, "bilstm_step": bl_timing}


@contextlib.contextmanager
def stage_timer(module, name: str, seconds: dict):
    """Wrap ``module.name`` so each call adds its wall (the card synchronised)
    to ``seconds[name]``; the CLI looks its functions up at call time."""
    fn = getattr(module, name)

    def timed(*a, **k):
        t0 = time.perf_counter()
        out = fn(*a, **k)
        torch.cuda.synchronize()
        seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t0
        return out

    setattr(module, name, timed)
    try:
        yield
    finally:
        setattr(module, name, fn)


def print_breakdown(path: str, fn) -> None:
    """``device_breakdown`` of one call of ``fn`` as a log line and its top kernels."""
    wall, busy, ranked = device_breakdown(fn, iters=3)
    log("breakdown", path=path, host_wall_ms=f"{wall:.3f}", device_kernel_ms=f"{busy:.3f}",
        busy_share=f"{busy / wall:.3f}")
    for k_ms, k_n, name in ranked:
        print(f"  {k_ms:8.3f} ms  x{k_n}  {name[:100]}", flush=True)


def cli_main_quiet(argv: list[str]) -> str:
    """The port's CLI in this process on the card; its stdout. Fails on a nonzero exit."""
    from audioanalysisdetector_tpu_torch.cli.main import main as cli_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(argv)
    if rc != 0:
        raise AssertionError(f"{argv[0]} CLI exited {rc}:\n{buf.getvalue()[-4000:]}")
    return buf.getvalue()


def cli_json(argv: list[str]) -> dict:
    """The port's CLI in this process on the card; its last stdout line as JSON."""
    return json.loads(cli_main_quiet(argv).strip().splitlines()[-1])


def gmm_rel_diff(a, b) -> float:
    """max |a - b| of two GMMs' parameters, each relative to a's largest entry."""
    a, b = to_numpy(a), to_numpy(b)
    return max(float(np.abs(a[k] - b[k]).max() / np.abs(a[k]).max()) for k in a)


def finite_eers(out: dict, where: str) -> None:
    eers = [out["bilstm"]["eer"], out["gmm"]["eer"], out["fused"]["eer"],
            *out["fused"].get("per_tier_eer", {}).values()]
    if not all(np.isfinite(e) and 0.0 <= e <= 1.0 for e in eers):
        raise AssertionError(f"{where}: EERs not finite in [0, 1]: {out}")


@functools.cache
def reduced_v5_corpus() -> dict:
    """Phase 11's reduced v5 surrogate corpus, synthesised once per run into
    a directory removed at exit: {split: (metadata, audio dir)}."""
    from audioanalysisdetector_tpu_torch.data.synthetic import make_surrogate_corpus

    d = tempfile.mkdtemp(prefix="chip_smoke_v5_")
    atexit.register(shutil.rmtree, d, True)
    return {split: make_surrogate_corpus(os.path.join(d, split), subset=split, seconds=4.5, seed=seed,
                                         channel="varied", **n)
            for split, seed, n in (("train", 0, dict(n_bonafide=6, n_spoof_per_tier=2)),
                                   ("eval", 1, dict(n_bonafide=12, n_spoof_per_tier=4)))}


def asvspoof_argv(corpus: dict, run_dir: str) -> list[str]:
    """``train-asvspoof`` on the reduced corpus with recipe v5's fusion, 3 epochs."""
    return ["train-asvspoof", corpus["train"][0], corpus["eval"][0], "--audio-dir", corpus["train"][1],
            corpus["eval"][1], "--epochs", "3", "--hidden", "64", "--gmm-components", "128", "--lr", "3e-4",
            "--gmm-cmvn", "--fusion-weight", "0.5", "--run-dir", run_dir, "--device", DEVICE]


def phase_gmm_train() -> None:
    """GMM-UBM training on the card: EM at the reference's scale (flat and
    chunked), MAP (flat and chunked, means only and full), EM and
    ``train_gmm_system`` card against CPU, ``eval_model``'s training branch,
    and the ``train-fused`` and ``train-asvspoof`` CLIs.

    ``train-asvspoof`` runs on a reduced v5 surrogate corpus (recipe v5 is
    train 180 bonafide + 60 per tier, eval 480 + 160 per tier, 40 epochs):
    train 6 + 2 per tier, eval 12 + 4 per tier, 4.5 s, channel "varied",
    3 epochs, 128 components, ``--gmm-cmvn``, fusion weight 0.5, hidden 64.
    The cuts: the corpus, whose host synthesis takes ~0.12 s a file on the
    card machine (the full v5 pair ~150 s; 144 files took 15.7 s and 72
    files 8.5 s, which kept the script past its time, so 36), and the
    epochs. The path reaches no TPU kernel (XLA computed it in the JAX
    package), so it runs plain PyTorch: cuBLAS SGEMM and elementwise passes.
    """
    from audioanalysisdetector_tpu_torch.cli import main as cli_mod
    from audioanalysisdetector_tpu_torch.train import gmm_system, loop, quality

    # 1. UBM EM at the reference's scale, flat then chunked
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    centers = rng.standard_normal((8, GMM_DIM)) * 2
    x = (centers[rng.integers(0, 8, GMM_FRAMES)] + rng.standard_normal((GMM_FRAMES, GMM_DIM))).astype(np.float32)
    xd = torch.from_numpy(x).to(DEVICE)
    torch.cuda.synchronize()
    log("gmm-train", frames=GMM_FRAMES, dim=GMM_DIM, components=GMM_K, data_s=f"{time.perf_counter() - t0:.2f}")
    fits = {}
    for path, kw in (("flat", {}), ("chunked", {"flat_bytes": 0, "chunk": 65536})):
        free()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        fits[path] = fit_em(xd, GMM_K, max_iter=100, tol=0.0, seed=42, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        if path == "flat":
            step = lambda: _em_step_flat(xd, fits["flat"])  # noqa: E731
        else:
            xc, wc = _pad_on_device(xd, torch.ones(GMM_FRAMES, device=DEVICE), 65536)
            step = lambda: _em_step(xc, wc, fits["chunked"])  # noqa: E731
        it_ms = cuda_ms(step, 5)
        log("gmm-train", em=path, iters=100, fit_s=f"{wall:.3f}", iter_ms=f"{it_ms:.3f}",
            peak_mem_gb=f"{peak / 1e9:.3f}", reference_cpu_sklearn_s=478.85)
        print_breakdown(f"em_{path}_iteration", step)
        del step
    with torch.no_grad():
        ll = {p: float(score_samples(xd, g).mean()) for p, g in fits.items()}
    path_diff = gmm_rel_diff(fits["flat"], fits["chunked"])
    ll_rel = abs(ll["flat"] - ll["chunked"]) / abs(ll["flat"])
    log("gmm-train", check="flat_vs_chunked", param_rel_diff=f"{path_diff:.3e}", mean_ll_flat=f"{ll['flat']:.6f}",
        mean_ll_chunked=f"{ll['chunked']:.6f}", ll_rel_diff=f"{ll_rel:.3e}")
    if path_diff > EM_PATH_RTOL or ll_rel > EM_LL_RTOL or not np.isfinite(ll["flat"]):
        raise AssertionError(f"EM flat vs chunked: params {path_diff:.3e}, LL {ll_rel:.3e}")

    # MAP, flat vs chunked, on both halves of the buffer, means only and full
    ubm = fits["flat"]
    half = (torch.arange(GMM_FRAMES, device=DEVICE) < GMM_FRAMES // 2).to(torch.float32)
    for mode in ("means", "full"):
        full = mode == "full"
        kw = dict(adapt_vars=full, adapt_weights=full)
        diffs = []
        for w in (half, 1.0 - half):
            diffs.append(gmm_rel_diff(map_adapt(ubm, xd, frame_weights=w, **kw),
                                      map_adapt_chunked(ubm, xd, frame_weights=w, **kw)))
        t = {name: cuda_ms(lambda f=f: f(ubm, xd, frame_weights=half, **kw), 3)
             for name, f in (("flat", map_adapt), ("chunked", map_adapt_chunked))}
        log("gmm-train", map=mode, flat_ms=f"{t['flat']:.3f}", chunked_ms=f"{t['chunked']:.3f}",
            flat_vs_chunked_rel_diff=f"{max(diffs):.3e}")
        if full:
            print_breakdown("map_full_flat", lambda: map_adapt(ubm, xd, frame_weights=half, **kw))
        if max(diffs) > MAP_RTOL:
            raise AssertionError(f"MAP {mode}: flat vs chunked {max(diffs):.3e} > {MAP_RTOL}")
    del xd, x, fits, ubm, half
    free()

    # 2. card against CPU: fit_em on 20k frames, K = 16
    x20 = (centers[rng.integers(0, 8, 20_000)] + rng.standard_normal((20_000, GMM_DIM))).astype(np.float32)
    em_dev = gmm_rel_diff(*(fit_em(x20, 16, seed=3, max_iter=30, tol=0.0, device=d) for d in ("cpu", DEVICE)))
    log("gmm-train", check="fit_em_card_vs_cpu", frames=20_000, components=16, param_rel_diff=f"{em_dev:.3e}")
    if em_dev > GMM_DEVICE_RTOL:
        raise AssertionError(f"fit_em card vs CPU {em_dev:.3e} > {GMM_DEVICE_RTOL}")

    # train_gmm_system on the CQCC of 512 utterances made as phase 9's,
    # K = 128, plain and with CMVN, 10 EM iterations: the npz files of both devices
    cfg = CQCCConfig()
    with torch.no_grad():
        cq = transpose_cqcc(cqcc(waves(512, 7), cfg)).cpu().numpy()
    cq = FrameScaler.fit_sequences(cq).transform(torch.from_numpy(cq)).numpy()
    y = np.random.default_rng(16).integers(0, 2, len(cq))
    for cmvn in (False, True):
        with tempfile.TemporaryDirectory() as d:
            walls = {}
            for device in (DEVICE, "cpu"):
                t0 = time.perf_counter()
                train_gmm_system(cq, y, n_components=GMM_K, cmvn=cmvn, max_iter=10,
                                 model_dir=os.path.join(d, device), device=device)
                walls[device] = time.perf_counter() - t0
            diff = 0.0
            for name in ("ubm", "gmm_genuine", "gmm_df"):
                with np.load(os.path.join(d, DEVICE, f"{name}.npz")) as a, \
                        np.load(os.path.join(d, "cpu", f"{name}.npz")) as b:
                    diff = max(diff, max(float(np.abs(a[k] - b[k]).max() / np.abs(b[k]).max()) for k in b.files))
        log("gmm-train", check="train_gmm_system_card_vs_cpu", cmvn=cmvn, frames=cq.shape[0] * cq.shape[1],
            components=GMM_K, npz_rel_diff=f"{diff:.3e}", card_s=f"{walls[DEVICE]:.3f}", cpu_s=f"{walls['cpu']:.3f}")
        if diff > GMM_DEVICE_RTOL:
            raise AssertionError(f"train_gmm_system card vs CPU (cmvn={cmvn}): {diff:.3e} > {GMM_DEVICE_RTOL}")

    # 3. eval_model's training branch on the card: no saved GMMs in the dir
    model, _, _ = fused_models(DEVICE)
    with tempfile.TemporaryDirectory() as d:
        _, y_pred, metrics = eval_model(model, cq[:384], y[:384], cq[384:], y[384:], model_dir=d,
                                        verbose=False, device=DEVICE)
        written = sorted(os.listdir(d))
    log("gmm-train", eval_model="training_branch", train_rows=384, test_rows=len(cq) - 384,
        accuracy=f"{metrics['accuracy']:.4f}", f1=f"{metrics['f1']:.4f}", eer=f"{metrics['eer']:.4f}",
        written=",".join(written))
    if written != ["feature_transform.json", "gmm_df.npz", "gmm_genuine.npz", "ubm.npz"] or not 0 <= metrics["eer"] <= 1:
        raise AssertionError(f"eval_model training branch: {written}, {metrics}")

    with tempfile.TemporaryDirectory() as d:
        # 4. train-fused over 64 seeded WAVs (bonafide noise, spoof noise + tone)
        rng = np.random.default_rng(17)
        t = np.arange(N_SAMPLES) / SR
        for label in ("bonafide", "spoof"):
            os.makedirs(os.path.join(d, "wavs", label))
            for i in range(32):
                w = rng.standard_normal(N_SAMPLES) * 0.1
                if label == "spoof":
                    w = w + 0.1 * np.sin(2 * np.pi * rng.uniform(300, 3000) * t)
                write_wav(os.path.join(d, "wavs", label, f"u{i:02d}.wav"), np.clip(w, -0.999, 0.999), SR)
        t0 = time.perf_counter()
        fused = cli_json(["train-fused", os.path.join(d, "wavs"), "--epochs", "3",
                          "--run-dir", os.path.join(d, "fused_run"), "--device", DEVICE])
        log("gmm-train", cli="train-fused", files=64, wall_s=f"{time.perf_counter() - t0:.2f}",
            json=json.dumps(fused, separators=(",", ":")))
        finite_eers(fused, "train-fused")

        # 5. train-asvspoof on the reduced v5 surrogate corpus
        t0 = time.perf_counter()
        corpus = reduced_v5_corpus()
        stages = {"synthesis": time.perf_counter() - t0}
        with stage_timer(quality, "build_cqcc_arrays", stages), stage_timer(loop, "bilstm_pipeline", stages), \
                stage_timer(gmm_system, "train_gmm_system", stages), \
                stage_timer(cli_mod, "_eval_fused_system", stages):
            t0 = time.perf_counter()
            asv = cli_json(asvspoof_argv(corpus, os.path.join(d, "asv_run")))
            stages["cli_total"] = time.perf_counter() - t0
    log("gmm-train", cli="train-asvspoof", json=json.dumps(asv, separators=(",", ":")))
    log("gmm-train", cli="train-asvspoof", **{f"{k}_s": f"{v:.2f}" for k, v in stages.items()})
    # 12 train files x two 2-s chunks, 12 of each class (no upsampling); 24 eval files x 2
    if (asv["n_train"], asv["n_eval"]) != (24, 48) or set(asv["fused"].get("per_tier_eer", {})) != {
            "A01", "A02", "A03"}:
        raise AssertionError(f"train-asvspoof: n_train/n_eval or tiers wrong: {asv}")
    finite_eers(asv, "train-asvspoof")
    free()


def feature_error(got: torch.Tensor, ref: torch.Tensor) -> float:
    """max |got - ref| relative to each row's largest |ref| (rows on axis 0)."""
    got, ref = got.double(), ref.double()
    peak = ref.abs().reshape(len(ref), -1).amax(dim=1).clamp_min(1e-30)
    return float(((got - ref).abs().reshape(len(ref), -1).amax(dim=1) / peak).max())


def pitch_error(got: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    """Pitch rows' error relative to each row's peak: (inside, last PITCH_TAIL samples)."""
    err = (got.double() - ref.double()).abs() / ref.double().abs().amax(dim=-1, keepdim=True)
    return float(err[:, :-PITCH_TAIL].max()), float(err[:, -PITCH_TAIL:].max())


def formant_rows(rng, n: int = 16) -> list[np.ndarray]:
    """Crude vowels: noise through two AR(2) resonators (F1, F2 drawn per
    file), a stretch of silence in each."""
    out = []
    for _ in range(n):
        e = rng.standard_normal(N_SAMPLES) * 0.01
        for f0 in (rng.uniform(400, 900), rng.uniform(1200, 2400)):
            a1, a2 = -2 * 0.97 * np.cos(2 * np.pi * f0 / SR), 0.97**2
            y = np.zeros_like(e)
            for t in range(2, len(e)):
                y[t] = e[t] - a1 * y[t - 1] - a2 * y[t - 2]
            e = y
        e = e / np.abs(e).max() * 0.5
        start = int(rng.integers(4000, 20000))
        e[start : start + 6000] = 0.0
        out.append(e)
    return out


def phase_features() -> dict:
    """The slice's extractors and augmentations on the card (B=8192 two-second
    utterances made there): each registry extractor plus the EDA
    spectrograms against the CPU, timed; K3 at 128 mels against its plain
    version, bound and cuFFT chain; ``apply_augmentations`` on a
    none/pitch/noise mix and a full-batch pitch shift; the iSTFT round trip;
    the formants cells over 16 files; the ``extract`` CLI (subprocesses, mfcc
    and lfcc) against ``extract_feature_array``; the ``augment`` CLI; and
    ``train-asvspoof --augment`` on phase 11's corpus. Returns the launches
    of K3 on the feature paths. The mel features run K3 (``mel_route`` at
    n_fft 2048 / hop 512); the rest ran on XLA in the JAX package, so it is
    plain PyTorch here (cuBLAS, cuDNN, elementwise passes)."""
    from audioanalysisdetector_tpu_torch.data.augment import (
        AUG_NOISE,
        AUG_NONE,
        AUG_PITCH,
        apply_augmentations,
        pitch_shift,
    )
    from audioanalysisdetector_tpu_torch.data.pipeline import default_extractors, extract_feature_array, extract_features
    from audioanalysisdetector_tpu_torch.frontend.eda import compute_cqt_spec, melspectrogram_znorm
    from audioanalysisdetector_tpu_torch.frontend.istft import istft
    from audioanalysisdetector_tpu_torch.frontend.stft import stft_realimag

    launches = 0
    wav = waves(BATCH, 12)
    wav_cpu = wav[:256].cpu()
    extractors = {**default_extractors(SR), "melspectrogram_znorm": melspectrogram_znorm,
                  "compute_cqt_spec": compute_cqt_spec}
    on_k3 = ("mfcc", "mel_spectrogram", "mfcc_deltas", "melspectrogram_znorm")
    with torch.no_grad():
        # 1. each extractor at B=8192: the counted run, peak memory, time, the CPU's 256 rows
        for name, fn in extractors.items():
            free()
            torch.cuda.reset_peak_memory_stats()
            out, counts = run_counted(lambda: fn(wav))
            peak = torch.cuda.max_memory_allocated()
            if name in on_k3:
                launches += expect_launched(counts, "ct_mel", f"features {name}")
            elif any(counts.values()):
                raise AssertionError(f"features {name}: launched {counts}, no kernel is on its path")
            if out.device.type != torch.device(DEVICE).type or out.shape[0] != BATCH or not bool(torch.isfinite(out).all()):
                raise AssertionError(f"features {name}: {tuple(out.shape)} on {out.device}, finite "
                                     f"{bool(torch.isfinite(out).all())}")
            ms = cuda_ms(lambda: fn(wav), 3)
            err = feature_error(out[:256].cpu(), fn(wav_cpu))
            log("features", name=name, batch=BATCH, shape="x".join(map(str, out.shape[1:])),
                ct_mel_launches=counts["ct_mel"], ms=f"{ms:.3f}", utt_per_s=f"{BATCH / ms * 1e3:.1f}",
                peak_mem_gb=f"{peak / 1e9:.3f}", rel_err_vs_cpu=f"{err:.3e}")
            if err > FEATURE_RTOL[name]:
                raise AssertionError(f"features {name}: card vs CPU {err:.3e} > {FEATURE_RTOL[name]}")
            if name in ("mel_spectrogram", "lfcc", "compute_cqt_spec"):
                print_breakdown(name, lambda: fn(wav))
            del out

        # 2. K3 at 128 mels (the MFCC configuration): kernel, plain, cuFFT chain, bound
        cfg = MFCCConfig.for_sr(SR).mel
        T = n_frames_for(N_SAMPLES, cfg.hop_length, cfg.n_fft, cfg.center)
        padded = center_pad(wav, cfg.n_fft, cfg.pad_mode).contiguous()
        k3 = lambda: ctm.ct_mel(padded, cfg, n_frames=T)  # noqa: E731
        library = stft_chain(padded, cfg)
        k3_err = rel_err(k3(), ctm.ct_mel_reference(padded, cfg, n_frames=T))
        t = in_turns(k3, lambda: ctm.ct_mel_reference(padded, cfg, n_frames=T), library)
        bound = mel_bound(cfg, BATCH * T, padded.numel() * 4)
        log("features", k3_n_mels=cfg.n_mels, batch=BATCH, kernel_ms=f"{t['ms']:.3f}",
            plain_ms=f"{t['plain_ms']:.3f}", kernel_runs="%.3f,%.3f" % t["runs"],
            plain_runs="%.3f,%.3f" % t["plain_runs"], rel_err_vs_plain=f"{k3_err:.3e}", **bound_fields(t, bound))
        if k3_err > REL_TOL:
            raise AssertionError(f"K3 at 128 mels: {k3_err:.3e} > {REL_TOL}")
        del padded, library
        free()

        # 3. apply_augmentations on a none/pitch/noise mix, then a full-batch pitch shift
        codes = torch.arange(BATCH, device=DEVICE) % 3  # AUG_NONE, AUG_PITCH, AUG_NOISE
        torch.cuda.reset_peak_memory_stats()
        aug = apply_augmentations(wav, codes, torch.Generator(device=DEVICE).manual_seed(0))
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        gen = torch.Generator(device=DEVICE).manual_seed(1)
        mix_ms = cuda_ms(lambda: apply_augmentations(wav, codes, gen), 2)
        none_same = bool(torch.equal(aug[codes == AUG_NONE], wav[codes == AUG_NONE]))
        noise_std = float((aug[codes == AUG_NOISE] - wav[codes == AUG_NOISE]).std())
        pitch_rows = torch.nonzero(codes[:256] == AUG_PITCH).reshape(-1)
        inside, tail = pitch_error(aug[pitch_rows].cpu(), pitch_shift(wav_cpu[pitch_rows.cpu()]))
        log("features", augment="none/pitch/noise", batch=BATCH, ms=f"{mix_ms:.3f}",
            peak_mem_gb=f"{peak / 1e9:.3f}", none_rows_unchanged=none_same,
            noise_residual_std=f"{noise_std:.6f}", pitch_rows_vs_cpu=len(pitch_rows),
            pitch_rel_err=f"{inside:.3e}", pitch_tail_rel_err=f"{tail:.3e}")
        if not none_same or abs(noise_std - 0.005) > NOISE_STD_TOL or inside > PITCH_RTOL or tail > PITCH_TAIL_RTOL:
            raise AssertionError(f"apply_augmentations: none rows unchanged {none_same}, noise std "
                                 f"{noise_std:.6f}, pitch {inside:.3e} / {tail:.3e}")
        print_breakdown("apply_augmentations", lambda: apply_augmentations(wav, codes, gen))
        del aug
        free()
        torch.cuda.reset_peak_memory_stats()
        pitch_ms = cuda_ms(lambda: pitch_shift(wav), 1)
        log("features", pitch_shift_full_batch=BATCH, ms=f"{pitch_ms:.3f}",
            peak_mem_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.3f}")
        free()
        re, im = stft_realimag(wav)
        back = istft(re, im, length=N_SAMPLES)
        trip = float((back - wav)[:, 2048:-2048].abs().max())
        log("features", istft_round_trip_max_err=f"{trip:.3e}")
        if trip > 1e-5:
            raise AssertionError(f"istft(stft_realimag(x)) round trip {trip:.3e} > 1e-5")
        del re, im, back, wav
        free()

    with tempfile.TemporaryDirectory() as d:
        # 4. the formants cells over 16 files, card against CPU
        rng = np.random.default_rng(12)
        fdir = os.path.join(d, "formants")
        os.mkdir(fdir)
        rows = []
        for i, y in enumerate(formant_rows(rng)):
            rows.append({"file_path": os.path.join(fdir, f"v{i:02d}.wav"), "chunk_start": 0.0, "chunk_end": 2.0})
            write_wav(rows[-1]["file_path"], y, SR)
        t0 = time.perf_counter()
        card = extract_features(rows, ["formants"], batch_size=16, device=DEVICE)
        wall = time.perf_counter() - t0
        cpu = extract_features(rows, ["formants"], batch_size=16, device="cpu")
        diff, counts_equal = 0.0, True
        for a, b in zip(card, cpu):
            a, b = a["formants"], b["formants"]
            if list(a) != list(b):
                raise AssertionError(f"formants: keys {list(a)} != {list(b)}")
            counts_equal &= all(a[k] == b[k] for k in b if isinstance(b[k], int))
            diff = max(diff, max(abs(a[k] - b[k]) for k in b if not isinstance(b[k], int)))
        log("features", formants_files=len(rows), wall_s=f"{wall:.2f}", counts_equal=counts_equal,
            max_float_diff_vs_cpu=f"{diff:.3e}", f1_segments=sum(c["formants"]["f1_total_segments"] for c in card))
        if not counts_equal or diff > 1e-6:
            raise AssertionError(f"formants card vs CPU: counts equal {counts_equal}, floats {diff:.3e}")

        # 5. the extract CLI in subprocesses (mfcc, lfcc at once) against extract_feature_array
        audio = os.path.join(d, "audio")
        os.mkdir(audio)
        t = np.arange(N_SAMPLES) / SR
        for i in range(64):
            y = rng.standard_normal(N_SAMPLES) * 0.05 + 0.2 * np.sin(2 * np.pi * rng.uniform(200, 4000) * t)
            write_wav(os.path.join(audio, f"u{i:02d}.wav"), np.clip(y, -0.999, 0.999), SR)
        t0 = time.perf_counter()
        procs = {f: subprocess.Popen(
            [sys.executable, "-m", "audioanalysisdetector_tpu_torch", "extract", audio, "--feature", f,
             "--batch-size", "64", "--output", os.path.join(d, f"{f}.npz"), "--device", DEVICE],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT) for f in ("mfcc", "lfcc")}
        outs = {f: p.communicate(timeout=600) for f, p in procs.items()}
        wall = time.perf_counter() - t0
        registry = default_extractors(SR)
        for f, (_, err_text) in outs.items():
            if procs[f].returncode != 0:
                raise AssertionError(f"extract CLI ({f}) exited {procs[f].returncode}:\n{err_text[-4000:]}")
            counts = json.loads(err_text.strip().splitlines()[-1])["kernel_launches"]
            if f == "mfcc":
                launches += expect_launched(counts, "ct_mel", "extract CLI mfcc")
            with np.load(os.path.join(d, f"{f}.npz")) as z:
                files, feats = list(z["files"]), z["features"]
            ref, ok = extract_feature_array([{"file_path": p} for p in files], registry[f], batch_size=64,
                                            device=DEVICE)
            err = feature_error(torch.from_numpy(feats), torch.from_numpy(ref))
            log("features", cli="extract", feature=f, files=len(files), shape="x".join(map(str, feats.shape)),
                launches=json.dumps(counts, separators=(",", ":")), rel_err_vs_pipeline=f"{err:.3e}",
                wall_s=f"{wall:.1f}")
            if len(files) != 64 or not ok.all() or err > EXTRACT_CLI_RTOL:
                raise AssertionError(f"extract CLI ({f}): {len(files)} files, {err:.3e} > {EXTRACT_CLI_RTOL}")

        # 6. the augment CLI over 8 WAVs: noise, pitch and shift variants of each
        few = os.path.join(d, "few")
        os.mkdir(few)
        for i in range(8):
            shutil.copy(os.path.join(audio, f"u{i:02d}.wav"), few)
        out_dir = os.path.join(d, "augmented")
        t0 = time.perf_counter()
        cli_main_quiet(["augment", few, "--output-dir", out_dir, "--device", DEVICE])
        written = sorted(os.listdir(out_dir))
        log("features", cli="augment", files=8, written=len(written), wall_s=f"{time.perf_counter() - t0:.2f}")
        if len(written) != 24:
            raise AssertionError(f"augment CLI wrote {len(written)} files, not 24")

    # 7. train-asvspoof --augment on phase 11's reduced corpus
    with tempfile.TemporaryDirectory() as d:
        corpus = reduced_v5_corpus()
        t0 = time.perf_counter()
        plain = cli_json(asvspoof_argv(corpus, os.path.join(d, "plain")))
        augmented = cli_json(asvspoof_argv(corpus, os.path.join(d, "augmented")) + ["--augment"])
    log("features", cli="train-asvspoof --augment", json=json.dumps(augmented, separators=(",", ":")))
    log("features", cli="train-asvspoof --augment", n_train=augmented["n_train"],
        n_train_without=plain["n_train"], wall_s=f"{time.perf_counter() - t0:.2f}")
    finite_eers(augmented, "train-asvspoof --augment")
    if augmented["n_train"] <= plain["n_train"] or augmented["n_eval"] != plain["n_eval"]:
        raise AssertionError(f"train-asvspoof --augment: train rows {augmented['n_train']} vs {plain['n_train']}")
    free()
    return {"ct_mel": launches}


def timed_phase(phase):
    """``phase()``, with its wall printed after it."""
    t0 = time.perf_counter()
    out = phase()
    log("phase", name=phase.__name__, wall_s=f"{time.perf_counter() - t0:.1f}")
    return out


def main() -> int:
    t0 = time.perf_counter()
    phase_device()
    timed_phase(phase_build)
    k1 = timed_phase(phase_k1)
    k3 = timed_phase(phase_k3)
    k2 = timed_phase(phase_k2)
    launches = {"wave_mel": 0, "ct_mel": 0, "fused_mel_from_frames": k2["launches"]}
    for part in (timed_phase(phase_e2e)[0], timed_phase(phase_serve), timed_phase(phase_score)):
        for name, n in part.items():
            launches[name] += n
    timed_phase(phase_fused)
    launches["ct_mel"] += timed_phase(phase_train)["ct_mel"]
    timed_phase(phase_gmm_train)
    launches["ct_mel"] += timed_phase(phase_features)["ct_mel"]
    timed = {
        "wave_mel": k1["parity"],
        "fused_mel_from_frames": k2[("parity", "float32")],
        "ct_mel": k3,
    }
    kernels = []
    for name, (source, replaces) in KERNEL_SOURCES.items():
        if launches[name] < 1:
            raise AssertionError(f"no main path launched {name}: {launches}")
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"audioanalysisdetector_tpu_torch/{source}",
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": timed[name]["max_abs_err"],
            "ms": timed[name]["ms"],
            "plain_ms": timed[name]["plain_ms"],
            "bound_ms": timed[name]["bound_ms"],
            "bound_by": timed[name]["bound_by"],
            "library_ms": timed[name]["library_ms"],
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    log("done", seconds=f"{time.perf_counter() - t0:.1f}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
