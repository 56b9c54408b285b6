#!/usr/bin/env python3
"""Card check of the PyTorch port: build, kernels vs plain, e2e, serving, CLI, training, features, multi, models and XAI, classical ML.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

It drives ``audioanalysisdetector_tpu_torch``'s main path (wav -> log-mel
through the hand-written mel kernel that ``frontend.mel.mel_route`` names —
``ct_mel`` (K3) at the parity profile, ``wave_mel`` (K1) at speech ->
CNN-BiLSTM -> score) at the flagship model's full width, in phases that
each print their lines:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA;
2. build: compiles ``ops/csrc/wave_mel.cu`` (K1 and K2),
   ``ops/csrc/ct_mel.cu`` (K3), ``ops/csrc/lstm_scan.cu`` and
   ``ops/csrc/lstm_scan_h32.cu`` (K4), ``ops/csrc/cqcc.cu`` (K5) and ``ops/csrc/gmm_llr.cu`` (K6) with nvcc, one process each, in parallel, and counts the tensor-core (``HGMMA``) instructions in wave_mel's SASS
   (``cuobjdump -sass``): none fails the phase;
3. K1: ``wave_mel`` against ``wave_mel_reference`` in both mel profiles
   (random input at B=8192, a ragged batch of 13, silence, length 32001,
   whose rows are not 16-byte aligned), at n_fft 400 / hop 160 (the 25 ms
   / 10 ms speech framing, a sample tail past the kernel's 32-sample
   stages), at n_fft 64 (fewer stages than the ring is deep), with 128
   mels, and at Whisper large-v3's log-mel (n_fft 400, 128 Slaney mels to
   8 kHz) on 16 30-s rows, whole and as 7-s clips zero-padded, and on the
   voxtral-detect cell's 2 300-s rows (30,001 frames), whole and as 65-s
   clips zero-padded, mel power and dB; then the configurations K1 took up last (power
   1, a bfloat16 waveform, also off 16-byte alignment, and 256 mels in two
   filter groups), each through ``melspectrogram``'s route too; then the
   kernel, plain and library times from CUDA events, in turns, beside the
   bound, for both profiles and the three new configurations at B=8192;
4. K3: ``ct_mel`` against ``ct_mel_reference`` and against K1's direct
   plain chain at parity (random B=8192, ragged 13, silence, length 32032,
   length 32001, whose odd padded rows take the 4-byte loads, 128 and 256
   mels), ``ct_mel_unpadded`` on the raw rows (the reflect pad folded into
   K3's frame addressing) bitwise equal to it, its log-mel against the
   plain dB, its time against its plain version, the library chain and K1
   in turns, beside the bound; K3 on raw rows against ``center_pad`` + K3
   and K3 on rows padded beforehand, in turns, at B=8192; the dB instance
   (``log_mel_spectrogram``'s route: ``power_to_db`` in K3's epilogue)
   bitwise K3's power + ``power_to_db`` in each case whose tile fits, one
   launch counted as ``ct_mel.db``, and its time against that chain and
   K3's power alone, in turns, at B=8192;
5. K2: ``fused_mel_from_frames`` against its plain version in float32 and
   bfloat16 (8192 utterances' frames, a ragged 100) in both profiles, with
   128 mels and at n_fft 100 off alignment, bf16 against f32, the times
   beside the bound and the library chain; then the drop-in
   ``fused_log_mel_spectrogram`` path in both dtypes, counting its launches;
5b. K4: ``lstm_scan`` at the fused scorer's shapes (B=8192, T=63, hidden
   128): layer 1's two directions in one launch (19 inputs, full output)
   and layer 2's forward scan (256 inputs, last step only), and at the mel
   model's (B=8192, T=32, 64 inputs, hidden 32, both directions, full
   output: the hidden-32 kernel, ``lstm_scan.h32``), against its plain
   version and ``nn.LSTM`` (cuDNN, a yardstick only), one launch each; the
   kernel, plain and cuDNN times in turns beside the bound and the input
   projection's time; ``BiLSTM`` calls with grad enabled keep cuDNN;
5c. K5: ``cqcc`` (raw waveform to CQCC in one launch) under ``cqcc()``
   against the plain chain on the card (B=8192 2-s clips, a ragged 13,
   silence, 1 s, 512 and 32,704 samples, a 3-D batch), frames whose
   regridded dB lies within 1e-3 of 0 left out; the kernel and plain times
   in turns beside the bound at B=8192; refused inputs keep the plain chain;
5d. K6: ``gmm_llr`` (the fused scorer's GMM arm in one launch) against
   the plain arm (``padding_mask`` + ``masked_llr``) on the card in fp32
   and in float64, at the fused cell's shapes (B=8192, T=63, D=19, two
   128-component GMMs, padded tails and empty rows) and at T=150 with K =
   13 and 256, D = 32 and D = 1: one launch each, the same bits twice, the
   empty rows alike; the arm's device work K6 alone; the kernel and plain
   times in turns beside the bound at B=8192; refused inputs (a frame
   transform, grad) keep the plain arm;
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
   utterances: ms per batch, utt/s, K4's launches a call (2: its BiLSTMs'
   recurrences), K5's (1: the frontend, whose device work is K5 alone, no
   CQT SGEMM), K6's (1: the GMM arm) and a ``torch.profiler`` breakdown, 256 rows against the
   port on the CPU; the same features through
   ``make_fused_scorer`` with the deltas + CMVN frame transform (D = 57
   GMMs); ``eval_model`` over a model dir written with ``to_numpy``, on the
   card and on the CPU. The path reaches no TPU kernel (XLA computed it in
   the JAX package): K5 for the CQCC, K4 for the recurrences, K6 for the
   GMMs, cuBLAS;
9b. whisper: Whisper large-v3's log-mel (``whisper_log_mel``: K1, then
    the published clip at each row's own max - 8) of 16 30-s rows, whole,
    as 7-s clips zero-padded, and silence, at mixed levels, against the
    plain chain on the CPU, one ``wave_mel`` launch; a row alone reads as
    in the batch, and a clip at the batch's max would miss by far more than
    the bound; then one ``make_whisper_mhfa_scorer`` call (the encoder and
    MHFA at the published widths) on those rows: exactly one K1 launch and
    no other hand-written kernel, ms per call and peak memory;
9c. voxtral: the whole-clip log-mel in windows (``whisper_log_mel_windows``:
    one K1 launch over 2 300-s clips, each clip's max, windows at levels of
    their own) against the plain chain on the CPU, the frames at window
    edges read apart, a log-mel of each window alone far off; then one
    ``make_voxtral_detect_scorer`` call at the published widths (4.68 B
    parameters) on those clips: exactly one K1 launch and no other
    hand-written kernel, 20 windows and 7,540 decoder positions
    (``work_counts``), ms per call and peak memory;
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
13. multi: (a) ``serve.multiproc.MultiprocessServer`` with 2 and then 4
    HTTP workers in front of one owner process running the parity scorer
    (K3 on every batch, ``max_batch`` 256), after the same traffic at the
    single-process ``ScoreServer`` in this process: 16 client threads send
    2-s rows to ``/v1/score_raw`` (4 rows a request) and as ``pcm`` JSON;
    every score against the direct scorer, ``/v1/stats`` summed over the
    workers, utt/s and p50/p99 latency, the owner's K3 launches read back
    from it, and only the owner holding the card (its ``/dev/nvidia*``
    descriptors; ``nvidia-smi --query-compute-apps`` printed beside); (b)
    ``fit(data_parallel=True)`` with sync-BN at world size 1 over NCCL
    against the single-process ``fit`` on the same K3 features, and the DP
    step's time against the single step's; (c) ``make_sharded_masked_llr``
    at the fused scorer's widths against ``masked_llr``; (d)
    ``dryrun_multichip(1)``; (e) (b) and (c) on 2 gloo ranks sharing the
    card, or a line saying why they did not run;
14. models-xai: (a) ``AntiSpoofingResNet``, ``MoreFeaturesClassifier`` (on
    the CQCC, GFCC and MFCC of the batch) and ``MobileNetMFCA`` at their
    published widths on 256 utterances' features made on the card (log-mel
    and MFCC through K3): eval logits against the CPU's, one train step's
    loss and BatchNorm statistics against the CPU's (dropout 0), ms per
    forward and per step at batch 256, the kernels a step launches; (b)
    saliency, IG (20 steps), occlusion with the (1, 5) window (3776
    windows; the CPU recomputes three rows of the map), Grad-CAM and LIME
    (30 perturbations) of the ResNet on one utterance's log-mel, and
    ``compare_gmm_bilstm`` at the fused widths (its IG through cuDNN's LSTM
    backward), each against the CPU, with ms; (c) the ``xai`` CLI (all
    five methods, ``--html``) on a WAV made on the card, ``train-mfca`` and
    ``train-3features`` for 2 epochs over 16 WAVs, each best checkpoint
    scored on the card against the CPU, K3's launches counted. No TPU
    kernel is on these paths but K3: cuDNN and autograd;
15. classical: (a) ``StandardScaler``, ``PCA(40)``, ``FastICA(40)``, ``SVC``
    (rbf, C 1 and 10, on the 40 PCA components) and the gradient-boosted
    trees (100 iterations, depth 5) of ``ml/`` at ``classical_main``'s fold
    scale (4,800 x 76 seeded features), each on the card against the port
    on the CPU, with ms per fit, SMO steps, trees and leaves; (b)
    and SMO's eager loop against its CUDA graph from 16 rows to 4,800;
    (b) ``classical_main``'s two grids (``train.classical.svm_grid``,
    ``xgb_grid``; cv=3) on 7,200 balanced rows cut to one candidate each,
    seconds per grid and the best parameters; (c)
    the ``classical`` and ``gridsearch`` CLIs over a small surrogate corpus
    on the card, their accuracies, best parameters and CSV equal to the
    same commands' with ``--device cpu``, K3's launches (their MFCC at 128
    mels) counted; (d) ``utils.StepTimer`` around a K3 call and a
    ``device_trace`` file of ``ct_mel_unpadded`` (traced in a process of its
    own) holding K3's kernel and no reflect-pad kernel. No
    TPU kernel is on this path (the JAX package runs scikit-learn on the
    host): plain PyTorch;
16. the result: a JSON line of the kernels, then ``{"ok": true, ...}`` last.

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
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

from audioanalysisdetector_tpu_torch.convert import (
    flax_to_torch_bilstm_classifier,
    flax_to_torch_cnn_bilstm,
    flax_to_torch_resnet,
    random_diag_gmm,
    random_flax_bilstm_classifier,
    random_flax_cnn_bilstm,
    random_flax_mobilenet_mfca,
    random_flax_more_features,
    random_flax_resnet,
)
from audioanalysisdetector_tpu_torch.data.scaler import FrameScaler
from audioanalysisdetector_tpu_torch.frontend.cqcc import (
    CQCCConfig,
    _regrid_on,
    cqcc,
    cqcc_from_cqt_mag,
    transpose_cqcc,
)
from audioanalysisdetector_tpu_torch.frontend.cqt import cqt
from audioanalysisdetector_tpu_torch.frontend.db import amplitude_to_db
from audioanalysisdetector_tpu_torch.frontend.db import power_to_db
from audioanalysisdetector_tpu_torch.frontend.mel import (
    MelConfig,
    log_mel_spectrogram,
    mel_route,
    melspectrogram,
    whisper_log_mel,
    whisper_log_mel_windows,
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
from audioanalysisdetector_tpu_torch.models.lstm import BiLSTM
from audioanalysisdetector_tpu_torch.entry import dryrun_multichip
from audioanalysisdetector_tpu_torch.models.gmm import (
    DiagGMM,
    _em_step,
    _em_step_flat,
    _pad_on_device,
    fit_em,
    from_numpy,
    map_adapt,
    map_adapt_chunked,
    masked_llr,
    score_samples,
    to_numpy,
)
from audioanalysisdetector_tpu_torch.models.layers import flax_init_
from audioanalysisdetector_tpu_torch.models.mobilenet_mfca import MobileNetMFCA
from audioanalysisdetector_tpu_torch.models.resnet import AntiSpoofingResNet, MoreFeaturesClassifier
from audioanalysisdetector_tpu_torch.models.voxtral import reset_work_counts, work_counts
from audioanalysisdetector_tpu_torch.models.whisper import WHISPER_LARGE_V3
from audioanalysisdetector_tpu_torch.ops import _build, launch_counts, reset_launch_counts
from audioanalysisdetector_tpu_torch.parallel.mesh import initialize_distributed, make_mesh, make_mesh_2d
from audioanalysisdetector_tpu_torch.parallel.sharded_gmm import make_sharded_masked_llr
from audioanalysisdetector_tpu_torch.ops import cqcc as k5
from audioanalysisdetector_tpu_torch.ops import gmm_llr as k6
from audioanalysisdetector_tpu_torch.ops import ct_mel as ctm
from audioanalysisdetector_tpu_torch.ops import fused_logmel as flm
from audioanalysisdetector_tpu_torch.ops import lstm_scan as k4
from audioanalysisdetector_tpu_torch.ops import wave_mel as wm
from audioanalysisdetector_tpu_torch.score.e2e import (
    WHISPER_MHFA_SAMPLES,
    init_mel_cnn_bilstm,
    init_voxtral_detect,
    init_whisper_mhfa,
    make_cqcc_fused_scorer,
    make_mel_cnn_bilstm_scorer,
    make_voxtral_detect_scorer,
    make_whisper_mhfa_scorer,
)
from audioanalysisdetector_tpu_torch.score.fused import arm_scores, make_fused_scorer, padding_mask
from audioanalysisdetector_tpu_torch.train import (
    TrainState,
    bilstm_pipeline,
    fit,
    get_loss,
    make_optimizer,
    make_train_step,
)
from audioanalysisdetector_tpu_torch.train.checkpoint import load_payload
from audioanalysisdetector_tpu_torch.train.gmm_system import eval_model, make_gmm_feature_fn, train_gmm_system
from audioanalysisdetector_tpu_torch.train.steps import make_dp_train_step, shard_batch
from audioanalysisdetector_tpu_torch.serve.multiproc import MultiprocessServer
from audioanalysisdetector_tpu_torch.serve.server import (
    BatchingScorer,
    ScoreServer,
    build_mel_scorer,
    default_bucket_ladder,
)
from portbench.yardstick.counts import bilstm_classifier_ops, cqcc_ops, gmm_pair_ops
from portbench.yardstick.peaks import FP32_FLOP_PER_S, HBM_BYTES_PER_S

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
# the same where Slaney filters are narrower than the bin spacing: past 128
# mels at n_fft 512 (256 filters below ~1 kHz against 31.25-Hz bins), and
# Whisper's 128 mels to 8 kHz at n_fft 400 (23-Hz filter spacing below 1
# kHz against 40-Hz bins). Many filters there hold one bin at an edge
# weight and their power is that bin's alone, down to the -80 dB floor,
# with no neighbour to average its relative DFT error (the CPU emulation of
# the kernel reads 9.2e-4 dB at -70.6 dB on 16 rows; an H100 7.7e-3 dB on
# 8192 rows at 256 mels, at 2.9e-6 of the max power, and 3.98e-3 dB on 16
# of Whisper's 30-s rows at a relative power error of 1.6e-6)
DB_TOL_MANY_MELS = 3e-2
# Whisper's log-mel, card vs the plain chain on the CPU, in its own units
# ((log10 + 4) / 4, so 40 dB a unit): DB_TOL_MANY_MELS, as its filters are
# narrower than its bins; a clip at the batch's max - 8 moves the quieter
# rows' padded frames by 0.1 or more
WHISPER_LOGMEL_TOL = DB_TOL_MANY_MELS / 40.0
# the voxtral-detect cell's clips: 300 s, ten 30-s windows
VOXTRAL_SAMPLES = 10 * WHISPER_MHFA_SAMPLES
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
    "lstm_scan": ("ops/csrc/lstm_scan.cu", "no TPU kernel: cuDNN's RNN_blockPersist_fp_LSTM under nn.LSTM"),
    "lstm_scan.h32": ("ops/csrc/lstm_scan_h32.cu",
                      "no TPU kernel: cuDNN's RNN_blockPersist_fp_LSTM under the mel model's nn.LSTM (hidden 32)"),
    "cqcc": ("ops/csrc/cqcc.cu", "no TPU kernel: the plain CQT -> CQCC chain's SGEMMs, cat and elementwise passes"),
    "gmm_llr": ("ops/csrc/gmm_llr.cu", "no TPU kernel: the plain GMM arm's SGEMMs, elementwise and reduction passes"),
}
# K4 against its plain version, both fp32 on the card: the same steps, the
# h W_hh^T sums taken in other orders over 63 steps (an H100 read 1.8e-7)
LSTM_PLAIN_TOL = 2e-6
# K4 against cuDNN's LSTM, which rounds its input product and its gates
# otherwise (the plain version and K4 alike read up to 8.1e-6 from it)
LSTM_CUDNN_TOL = 5e-5
# K5 against the plain chain on the card, both fp32, on the coefficients
# (up to ~60; -253 for silence): the CQT's sums in other orders and |X|^2
# without the sqrt move a bin's dB by a few ulps; the log quirk
# log(dB^2 + 1e-12) multiplies that by 2 / |dB|, so frames whose regridded dB
# lies within the fused cell's min_abs_interp_db (1e-3) of 0 are left out, as
# the benchmark's reference leaves them out. An H100 read 1.24e-3 at most
# (K5 4.4e-4 and the plain chain 8.0e-4 from the plain chain in float64)
K5_TOL = 5e-3
K5_MIN_ABS_INTERP_DB = 1e-3
# K6 against the plain arm (padding_mask + masked_llr), both fp32, and
# against the plain arm in float64, on the per-utterance LLR (|LLR| of a few
# units): each frame's log-likelihoods (~-30) carry ~1e-6 of rounding from
# the quadratic expansion's terms (the kernel's tables rounded to float32,
# the plain path's two SGEMMs of K = 19), the mean over the frames less; the
# benchmark's score_gap limit of 5e-5 allows ~4e-4 of LLR (sigmoid slope
# 1/4, weight 1/2)
K6_TOL = 1e-4


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
    output written once, at HBM_BYTES_PER_S. Kept beside
    ``portbench/yardstick/counts.py::mel_bound``, which takes the raw f32
    waveform as the bytes read: the kernels here read padded rows, bf16
    rows or K2's frame matrix."""
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
    Their ratio is the card's busy share. Kept beside
    ``portbench/harness/trace.py::Window``: that clips device time to its
    host range, which over 5 calls on an H100 left out one of five K3
    launches; this counts every one."""
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


def extra_bytes(fn) -> int:
    """Device memory ``fn()`` holds at its peak beyond what was allocated
    before it (its output and transients)."""
    free()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


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
    libs = ("wave_mel", "ct_mel", "lstm_scan", "lstm_scan_h32", "cqcc", "gmm_llr")
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
    """K1 vs plain in both profiles, at n_fft 400 and 64, with 128 mels and
    at Whisper's and Voxtral's shapes; returns the numbers (and times) of
    the two profiles."""
    results = {}
    configs = [(p, MelConfig.for_profile(p, SR), K1_CASES) for p in PROFILES]
    configs.append(("n_fft400", MelConfig(sr=SR, n_fft=400, hop_length=160),
                    (("random", 64, N_SAMPLES), ("length32001", 13, 32001))))
    configs.append(("mels128", MelConfig.for_speech(SR, n_mels=128), (("ragged", 13, N_SAMPLES),)))
    # Whisper large-v3's log-mel (n_fft 400, 128 Slaney mels to 8 kHz) at
    # the whisper-mhfa cell's shape: 16 30-s windows (3,001 frames)
    configs.append(("whisper", WHISPER_LARGE_V3.mel,
                    (("random", 16, WHISPER_MHFA_SAMPLES), ("padded7s", 16, WHISPER_MHFA_SAMPLES))))
    # the same log-mel over the voxtral-detect cell's whole clips: 2 rows of
    # 300 s (30,001 frames), whose frames cross every 30-s window edge
    configs.append(("voxtral", WHISPER_LARGE_V3.mel,
                    (("random", 2, VOXTRAL_SAMPLES), ("padded65s", 2, VOXTRAL_SAMPLES))))
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
            if case == "padded7s":  # 7-s clips zero-padded to the window, as Whisper's extractor pads
                wav[:, 7 * SR:] = 0.0
            if case == "padded65s":  # 65-s clips zero-padded to whole windows, as VoxtralProcessor pads
                wav[:, 65 * SR:] = 0.0
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
            db_tol = DB_TOL if cfg.n_mels <= 128 and profile not in ("whisper", "voxtral") else DB_TOL_MANY_MELS
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
        raw, counts = run_counted(lambda: ctm.ct_mel_unpadded(wav, cfg))
        if not torch.equal(raw, got) or counts["ct_mel.reflect"] != 1:
            raise AssertionError(f"K3 {case}: on raw rows not bitwise K3 on padded rows ({counts})")
        del raw
        ref = ctm.ct_mel_reference(padded, cfg, n_frames=T)
        rel_ct = rel_err(got, ref)
        max_abs = max(max_abs, float((got - ref).abs().max()))
        del ref
        direct = wm.wave_mel_reference(padded, cfg, n_frames=T)
        rel_direct = rel_err(got, direct)
        db_ref = power_to_db(direct.transpose(1, 2), ref="max", top_db=80.0)
        del direct
        db = float((ctm.ct_log_mel(wav, cfg) - db_ref).abs().max())
        in_db = not ctm.db_refusals(wav, cfg)  # 256 mels: the tile leaves one block an SM
        if in_db:
            db_k3, counts = run_counted(lambda: log_mel_spectrogram(wav, cfg))
            if not torch.equal(db_k3, power_to_db(got.transpose(1, 2), ref="max", top_db=80.0)) \
                    or counts["ct_mel.db"] != 1 or counts["ct_mel"] != 1:
                raise AssertionError(f"K3 {case}: the dB instance is not K3's power + power_to_db ({counts})")
            del db_k3
        log("k3", case=case, batch=batch, n=n, n_mels=cfg.n_mels,
            rel_err_vs_ct_plain=f"{rel_ct:.3e}", rel_err_vs_direct_plain=f"{rel_direct:.3e}",
            db_err=f"{db:.3e}", db_instance_bitwise=in_db or "refused")
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
    # the reflect pad folded into K3 against the pad as its own copy, and K3
    # on rows padded beforehand (the edge frames' reflected loads alone)
    raw = lambda: ctm.ct_mel_unpadded(wav, cfg)  # noqa: E731
    pad_then_k3 = lambda: ctm.ct_mel(center_pad(wav, cfg.n_fft, cfg.pad_mode), cfg, n_frames=T)  # noqa: E731
    fold = in_turns(raw, pad_then_k3, k3)
    log("k3_raw", batch=BATCH, raw_ms=f"{fold['ms']:.3f}", pad_then_k3_ms=f"{fold['plain_ms']:.3f}",
        k3_on_padded_ms=f"{fold['library_ms']:.3f}", raw_runs="%.3f,%.3f" % fold["runs"],
        pad_then_k3_runs="%.3f,%.3f" % fold["plain_runs"], k3_on_padded_runs="%.3f,%.3f" % fold["library_runs"],
        raw_extra_bytes=extra_bytes(raw), pad_then_k3_extra_bytes=extra_bytes(pad_then_k3))
    # the dB instance against K3's power + power_to_db, and K3's power alone
    db_k3 = lambda: log_mel_spectrogram(wav, cfg)  # noqa: E731
    power_db = lambda: power_to_db(raw().transpose(1, 2), ref="max", top_db=80.0)  # noqa: E731
    dbt = in_turns(db_k3, power_db, raw)
    log("k3_db", batch=BATCH, db_ms=f"{dbt['ms']:.3f}", power_then_db_ms=f"{dbt['plain_ms']:.3f}",
        k3_power_ms=f"{dbt['library_ms']:.3f}", db_runs="%.3f,%.3f" % dbt["runs"],
        power_then_db_runs="%.3f,%.3f" % dbt["plain_runs"], k3_power_runs="%.3f,%.3f" % dbt["library_runs"],
        db_extra_bytes=extra_bytes(db_k3), power_then_db_extra_bytes=extra_bytes(power_db))
    del wav, padded
    free()
    return {**t, **bound, "max_abs_err": max_abs, "k1_ms": route["plain_ms"], "db_ms": dbt["ms"]}


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


def lstm_bound(batch: int, steps: int, n_dirs: int, last_only: bool, hidden: int) -> dict:
    """The least time the card could take for ``n_dirs`` LSTM scans of
    ``hidden`` units (``ops/csrc/lstm_scan.cu``'s and ``lstm_scan_h32.cu``'s
    bound): the larger of the ``h W_hh^T`` operations, 2 B T 4H H a
    direction, at FP32_FLOP_PER_S, and the bytes, the input gates (B T 4H a
    direction) and W_hh read once and the output written once, at
    HBM_BYTES_PER_S. The input projection is a separate product, outside
    the bound."""
    gates = 4 * hidden
    ops = 2 * batch * steps * gates * hidden * n_dirs
    bytes_ = 4 * n_dirs * (batch * steps * gates + gates * hidden + batch * (1 if last_only else steps) * hidden)
    ops_ms, bytes_ms = ops / FP32_FLOP_PER_S * 1e3, bytes_ / HBM_BYTES_PER_S * 1e3
    by = "operations" if ops_ms >= bytes_ms else "bytes"
    return {"bound_ms": max(ops_ms, bytes_ms), "bound_by": by, "ops_ms": ops_ms, "bytes_ms": bytes_ms}


# (name, inputs, steps, hidden, last_only): the fused classifier's two layers, the mel model's BiLSTM
K4_CASES = (("layer1", 19, 63, 128, False), ("layer2", 256, 63, 128, True), ("mel", 64, 32, 32, False))


def phase_k4() -> dict:
    """K4 vs its plain version and cuDNN at the fused scorer's two layers
    and the mel model's BiLSTM; returns, by launch counter, the fused
    layer 1's numbers (the launch of both directions) and the mel case's."""
    out = {}
    for layer, inputs, steps, hidden, last_only in K4_CASES:
        counter = k4.KERNELS[hidden][2]
        torch.manual_seed(21)
        lstm = torch.nn.LSTM(inputs, hidden, batch_first=True, bidirectional=not last_only).to(DEVICE)
        x = torch.randn(BATCH, steps, inputs, device=DEVICE)
        sfx = ("",) if last_only else ("", "_reverse")
        ws = tuple(getattr(lstm, f"weight_hh_l0{s}") for s in sfx)
        with torch.inference_mode():
            xg = k4.input_gates(x, lstm, sfx)
            kern = lambda: k4.lstm_scan(xg, ws, last_only=last_only)  # noqa: E731
            plain = lambda: k4.lstm_scan_reference(xg, ws, last_only=last_only)  # noqa: E731
            got, counts = run_counted(kern)
            ref = plain()
            lib = lstm(x)[0]
            lib = lib[:, -1] if last_only else lib
            err_plain = float((got - ref).abs().max())
            err_lib = float((got - lib).abs().max())
            plain_lib = float((ref - lib).abs().max())
            del got, ref, lib
            t = in_turns(kern, plain, lambda: lstm(x))
            proj_ms = cuda_ms(lambda: k4.input_gates(x, lstm, sfx), 5)
        bound = lstm_bound(BATCH, steps, len(ws), last_only, hidden)
        flop = 2 * BATCH * steps * 4 * hidden * hidden * len(ws)
        log("k4", layer=layer, kernel=counter, batch=BATCH, steps=steps, inputs=inputs, hidden=hidden,
            directions=len(ws), last_only=last_only,
            launches=counts[counter], err_vs_plain=f"{err_plain:.3e}", err_vs_cudnn=f"{err_lib:.3e}",
            plain_vs_cudnn=f"{plain_lib:.3e}", kernel_ms=f"{t['ms']:.3f}", plain_ms=f"{t['plain_ms']:.3f}",
            kernel_runs="%.3f,%.3f" % t["runs"], plain_runs="%.3f,%.3f" % t["plain_runs"],
            kernel_tflops=f"{flop / t['ms'] / 1e9:.2f}", projection_ms=f"{proj_ms:.3f}",
            **bound_fields(t, bound))
        if counts[counter] != 1 or sum(counts.values()) != 1 or err_plain > LSTM_PLAIN_TOL or err_lib > LSTM_CUDNN_TOL:
            raise AssertionError(f"K4 {layer}: {counts}, {err_plain:.3e} from plain (> {LSTM_PLAIN_TOL}?), "
                                 f"{err_lib:.3e} from cuDNN (> {LSTM_CUDNN_TOL}?)")
        out[layer] = {**t, **bound, "max_abs_err": err_plain}
        del lstm, x, xg
        free()
    # grad mode: the parameters require grad, so BiLSTM keeps cuDNN and its gradients
    for inputs, steps, hidden in ((19, 63, 128), (64, 32, 32)):
        bi = BiLSTM(inputs, hidden).to(DEVICE)
        x = torch.randn(64, steps, inputs, device=DEVICE, requires_grad=True)
        _, counts = run_counted(lambda: bi(x).sum().backward())
        if any(counts.values()) or x.grad is None or bi.lstm.weight_hh_l0.grad is None:
            raise AssertionError(f"K4 launched under grad mode or the gradients are gone ({counts})")
        log("k4", hidden=hidden, grad_mode_launches=sum(counts.values()), grads_kept=True)
    return {"lstm_scan": {**out["layer1"], "max_abs_err": max(out[k]["max_abs_err"] for k in ("layer1", "layer2")),
                          "layer2_ms": out["layer2"]["ms"]},
            "lstm_scan.h32": out["mel"]}


def plain_cqcc(y: torch.Tensor, cfg: CQCCConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain chain's CQCC of ``y`` (B, n) and each frame's smallest
    |regridded dB| (B, T), where the log quirk is steepest."""
    mag = cqt(y, cfg.cqt)
    interp = _regrid_on(cfg.cqt, y.device, y.dtype) @ amplitude_to_db(mag, ref="max")
    return cqcc_from_cqt_mag(mag, cfg), interp.abs().amin(dim=-2)


def cqcc_bound(batch: int, n: int) -> dict:
    """The least time the card could take for the CQCC of ``batch`` clips of
    ``n`` samples (``ops/csrc/cqcc.cu``'s bound): the larger of the
    yardstick's operations (``cqcc_ops``) at FP32_FLOP_PER_S and the bytes,
    the waveform read once and the (19, T) output written once, at
    HBM_BYTES_PER_S."""
    bench_cfg = json.loads((ROOT / "portbench" / "configs" / "cqcc-fused.json").read_text())
    ops = batch * cqcc_ops({**bench_cfg, "n_samples": n})
    bytes_ = 4 * batch * (n + k5.N_CEPS * (1 + n // 512))
    ops_ms, bytes_ms = ops / FP32_FLOP_PER_S * 1e3, bytes_ / HBM_BYTES_PER_S * 1e3
    by = "operations" if ops_ms >= bytes_ms else "bytes"
    return {"bound_ms": max(ops_ms, bytes_ms), "bound_by": by, "ops_ms": ops_ms, "bytes_ms": bytes_ms}


def phase_k5() -> dict:
    """K5 vs the plain chain: B=8192 2-s clips, a ragged 13, silence, 1 s,
    the shortest and longest lengths it takes and a 3-D batch, each one
    launch under ``cqcc()``; the kernel and plain times in turns beside the
    bound at B=8192; inputs it refuses keep the plain chain."""
    cfg = CQCCConfig()
    out = {}
    cases = (("random", (BATCH,), N_SAMPLES), ("ragged", (13,), N_SAMPLES), ("silence", (64,), N_SAMPLES),
             ("n16000", (64,), 16000), ("n512", (7,), 512), ("n32704", (64,), k5.MAX_LENGTH),
             ("batch3d", (2, 8), N_SAMPLES))
    worst = 0.0
    for name, lead, n in cases:
        rows = int(np.prod(lead))
        y = torch.zeros(rows, n, device=DEVICE) if name == "silence" else waves(rows, 31 + n, n)
        with torch.inference_mode():
            got, counts = run_counted(lambda: cqcc(y.reshape(*lead, n), cfg))
            ref, small = plain_cqcc(y, cfg)
        got = got.reshape(rows, k5.N_CEPS, -1)
        keep = torch.ones_like(small, dtype=torch.bool) if name == "silence" else small >= K5_MIN_ABS_INTERP_DB
        err = float(((got - ref).abs() * keep[:, None, :]).max())
        worst = max(worst, err)
        # both fp32 chains against the plain chain in float64, on up to 64 rows
        ref64 = plain_cqcc(y[:64].double(), cfg)[0]
        k64, p64 = (float(((a[:64] - ref64).abs() * keep[:64, None, :]).max()) for a in (got, ref))
        log("k5", case=name, shape="x".join(map(str, (*lead, n))), launches=counts["cqcc"],
            frames_compared=f"{int(keep.sum())}/{keep.numel()}", max_abs_err=f"{err:.3e}",
            all_frames_err=f"{float((got - ref).abs().max()):.3e}", kernel_vs_f64=f"{k64:.3e}",
            plain_vs_f64=f"{p64:.3e}", finite=bool(torch.isfinite(got).all()))
        if counts["cqcc"] != 1 or err > K5_TOL or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"K5 {name}: {counts}, {err:.3e} from the plain chain (> {K5_TOL}?)")
        del got, ref, small, ref64
    y = waves(BATCH, 7)
    with torch.inference_mode():
        kern = lambda: k5.cqcc_kernel(y, cfg)  # noqa: E731
        plain = lambda: cqcc_from_cqt_mag(cqt(y, cfg.cqt), cfg)  # noqa: E731
        t = in_turns(kern, plain)
        peak = extra_bytes(kern), extra_bytes(plain)
    bound = cqcc_bound(BATCH, N_SAMPLES)
    log("k5", batch=BATCH, n=N_SAMPLES, kernel_ms=f"{t['ms']:.3f}", plain_ms=f"{t['plain_ms']:.3f}",
        kernel_runs="%.3f,%.3f" % t["runs"], plain_runs="%.3f,%.3f" % t["plain_runs"],
        kernel_tflops=f"{bound['ops_ms'] * FP32_FLOP_PER_S / 1e3 / t['ms'] / 1e9:.2f}",
        extra_bytes_kernel=peak[0], extra_bytes_plain=peak[1], **bound_fields(t, bound))
    # refused inputs keep the plain chain: grad on an input that requires grad, a length off 64
    for why, y2 in (("grad", waves(4, 3).requires_grad_(True)), ("length", waves(4, 3, N_SAMPLES + 1))):
        _, counts = run_counted(lambda: cqcc(y2, cfg))
        if counts["cqcc"]:
            raise AssertionError(f"K5 launched on an input refused for {why}")
        log("k5", refused=why, launches=counts["cqcc"])
    out = {**t, **bound, "max_abs_err": worst}
    del y
    free()
    return out


def gmm_bound(batch: int) -> dict:
    """The least time the card could take for the fused scorer's GMM arm
    over ``batch`` 2-s utterances (``ops/csrc/gmm_llr.cu``'s bound,
    ``portbench/metrics/k6_roofline.py``'s): the larger of the yardstick's
    operations (``gmm_pair_ops``) at FP32_FLOP_PER_S and the bytes, the
    (63, 19) coefficients read once and each utterance's LLR and empty flag
    written once, at HBM_BYTES_PER_S."""
    bench_cfg = json.loads((ROOT / "portbench" / "configs" / "cqcc-fused.json").read_text())
    ops = batch * gmm_pair_ops(bench_cfg)
    bytes_ = batch * (4 * (1 + N_SAMPLES // 512) * bench_cfg["n_ceps"] + 4 + 1)
    ops_ms, bytes_ms = ops / FP32_FLOP_PER_S * 1e3, bytes_ / HBM_BYTES_PER_S * 1e3
    by = "operations" if ops_ms >= bytes_ms else "bytes"
    return {"bound_ms": max(ops_ms, bytes_ms), "bound_by": by, "ops_ms": ops_ms, "bytes_ms": bytes_ms}


def plain_arm(x: torch.Tensor, spoof, genuine) -> tuple[torch.Tensor, torch.Tensor]:
    """K6's plain version, ``arm_scores``' GMM arm: (llr_spoof, empty)."""
    mask = padding_mask(x)
    return masked_llr(x, mask, spoof, genuine), mask.sum(-1) == 0


def gmm_frames(batch: int, t: int, d: int, seed: int) -> torch.Tensor:
    """Standard normal frames on the card with the fused scorer's padding:
    every 7th row cut to a seeded length in [1, t) (zeros after it), every
    97th row all zeros."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    x = torch.randn((batch, t, d), generator=g, device=DEVICE)
    lengths = torch.full((batch,), t, device=DEVICE)
    lengths[::7] = torch.randint(1, t, (len(lengths[::7]),), generator=g, device=DEVICE)
    lengths[::97] = 0
    return x * (torch.arange(t, device=DEVICE)[None, :] < lengths[:, None])[..., None]


def phase_k6() -> dict:
    """K6 vs the plain arm (``padding_mask`` + ``masked_llr``) on the card in
    fp32 and in float64: the fused cell's shapes (B=8192, T=63, D=19, two
    128-component GMMs) with padded tails and empty rows, then T=150 (three
    passes) with K = 13 and 256, D = 32 and D = 1, each one launch, the
    same bits twice; the kernel's device work alone, and the kernel and
    plain times in turns beside the bound at B=8192; inputs it refuses keep
    the plain arm."""
    model, g, s = fused_models(DEVICE)
    cases = (("fused", BATCH, 63, 19, 128, 128), ("t150_k13_k256", 512, 150, 19, 13, 256),
             ("d32", 512, 70, 32, 64, 64), ("d1", 512, 63, 1, 8, 9))
    dbl = lambda m: type(m)(*(p.double() for p in (m.weights, m.means, m.variances)))  # noqa: E731
    worst = 0.0
    for name, batch, t, d, ks, kg in cases:
        if name == "fused":
            spoof, genuine = s, g
        else:
            spoof = from_numpy(random_diag_gmm(3, ks, d), device=DEVICE)
            genuine = from_numpy(random_diag_gmm(4, kg, d), device=DEVICE)
        x = gmm_frames(batch, t, d, seed=batch + t + d)
        with torch.inference_mode():
            (llr, empty), counts = run_counted(lambda: k6.gmm_llr(x, spoof, genuine))
            again, _ = k6.gmm_llr(x, spoof, genuine)
            ref, ref_empty = plain_arm(x, spoof, genuine)
            ref64, _ = plain_arm(x.double(), dbl(spoof), dbl(genuine))
        err = float((llr - ref).abs().max())
        k64, p64 = (float((a.double() - ref64).abs().max()) for a in (llr, ref))
        worst = max(worst, err, k64)
        same_empty = bool(torch.equal(empty, ref_empty))
        log("k6", case=name, shape=f"{batch}x{t}x{d}", components=f"{ks},{kg}", launches=counts["gmm_llr"],
            max_abs_err=f"{err:.3e}", kernel_vs_f64=f"{k64:.3e}", plain_vs_f64=f"{p64:.3e}",
            empty_rows=int(empty.sum()), same_empty=same_empty, empty_llr_zero=bool((llr[empty] == 0).all()),
            same_bits_twice=bool(torch.equal(llr, again)), llr_range=f"{float(ref.min()):.3f}..{float(ref.max()):.3f}")
        if (counts["gmm_llr"] != 1 or err > K6_TOL or k64 > K6_TOL or not same_empty or not int(empty.sum())
                or not bool((llr[empty] == 0).all()) or not torch.equal(llr, again)):
            raise AssertionError(f"K6 {name}: {counts}, {err:.3e} from the plain arm, {k64:.3e} from float64 "
                                 f"(> {K6_TOL}?), empty rows alike {same_empty}")
        del x, llr, empty, again, ref, ref_empty, ref64
    x = gmm_frames(BATCH, 63, 19, seed=11)
    with torch.inference_mode():
        kern = lambda: k6.gmm_llr(x, s, g)  # noqa: E731
        plain = lambda: plain_arm(x, s, g)  # noqa: E731
        _, kern_ms, ranked = device_breakdown(kern, iters=3)
        names = [name for _, _, name in ranked]
        log("k6", device_kernels=json.dumps(names), device_ms=f"{kern_ms:.3f}")
        if len(names) != 1 or "gmm_llr_kernel" not in names[0]:  # no SGEMM, elementwise or reduce pass left
            raise AssertionError(f"K6: the arm ran {names}, not K6 alone")
        t = in_turns(kern, plain, iters=20)
        peak = extra_bytes(kern), extra_bytes(plain)
    bound = gmm_bound(BATCH)
    log("k6", batch=BATCH, frames=63, dim=19, components=128, kernel_ms=f"{t['ms']:.4f}",
        plain_ms=f"{t['plain_ms']:.3f}", kernel_runs="%.4f,%.4f" % t["runs"],
        plain_runs="%.3f,%.3f" % t["plain_runs"],
        kernel_tflops=f"{bound['ops_ms'] * FP32_FLOP_PER_S / 1e3 / t['ms'] / 1e9:.2f}",
        extra_bytes_kernel=peak[0], extra_bytes_plain=peak[1], **bound_fields(t, bound))
    # refused inputs keep the plain arm: a frame transform, grad on the frames
    feats = gmm_frames(64, 63, 19, seed=12)
    for why, fn in (("feature_fn", lambda: arm_scores(model, g, s, feats, gmm_feature_fn=torch.neg)),
                    ("grad", lambda: arm_scores(model, g, s, feats.clone().requires_grad_(True)))):
        _, counts = run_counted(fn)
        if counts["gmm_llr"]:
            raise AssertionError(f"K6 launched on an input refused for {why}")
        log("k6", refused=why, launches=counts["gmm_llr"])
    del x, feats
    free()
    return {**t, **bound, "max_abs_err": worst}


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
        if counts["lstm_scan.h32"] != 1 or counts["lstm_scan"]:  # the BiLSTM(64, 32): K4's hidden-32 kernel
            raise AssertionError(f"e2e {profile}: {counts['lstm_scan.h32']} hidden-32 K4 launches a call, not 1 "
                                 f"({counts})")
        launches["lstm_scan.h32"] = launches.get("lstm_scan.h32", 0) + 1
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
        log("e2e", profile=profile, batch=BATCH, kernel=kernel, launches=n, lstm_scan_h32_launches=1,
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


def whisper_rows(seed: int) -> torch.Tensor:
    """16 30-s rows on the CPU, the whisper-mhfa cell's recipe (3 tones over
    60-7000 Hz, a noise share of 0.05-1, a peak level of 0.02-0.5) with the
    windows Whisper's clip normalisation acts on: rows 0-7 whole, rows 8-14
    7-s clips zero-padded to 30 s, as ``cli score`` pads them, and row 15
    silence. The levels alternate, so each row's max differs from the
    batch's."""
    g = torch.Generator().manual_seed(seed)
    t = torch.arange(WHISPER_MHFA_SAMPLES, dtype=torch.float64) / SR
    rows = torch.zeros((16, WHISPER_MHFA_SAMPLES))
    levels = torch.logspace(math.log10(0.02), math.log10(0.5), 15, dtype=torch.float64)[torch.randperm(15, generator=g)]
    for i in range(15):
        freqs = 60.0 + 6940.0 * torch.rand((3, 1), generator=g, dtype=torch.float64)
        tone = torch.sin(2 * math.pi * freqs * t).mean(0)
        share = 0.05 + 0.95 * float(torch.rand((), generator=g))
        x = (1 - share) * tone + share * torch.randn(WHISPER_MHFA_SAMPLES, generator=g, dtype=torch.float64)
        rows[i] = (levels[i] * x / x.abs().max()).float()
    rows[8:15, 7 * SR:] = 0.0
    return rows


def phase_whisper() -> dict:
    """Whisper large-v3 + MHFA's front end and scorer on the card: the
    log-mel of a mixed batch (``whisper_rows``) against the plain chain on
    the CPU, each row's clip its own (a row scored alone reads as in the
    batch; a batch-wide max would miss by far more than the bound), one
    ``wave_mel`` launch a log-mel; then one ``make_whisper_mhfa_scorer``
    call at the published widths on the same 16 rows, which launches K1
    exactly once and no other hand-written kernel. Returns the launches."""
    cfg = WHISPER_LARGE_V3.mel
    cpu_wav = whisper_rows(29)
    wav = cpu_wav.to(DEVICE)
    with torch.inference_mode():
        got, counts = run_counted(lambda: whisper_log_mel(wav, cfg))
        if counts["wave_mel"] != 1 or sum(counts.values()) != 1:
            raise AssertionError(f"whisper_log_mel: launches {counts}, want one wave_mel")
        want = whisper_log_mel(cpu_wav, cfg)
        err = float((got.cpu() - want).abs().max())
        alone = max(float((whisper_log_mel(wav[i:i + 1], cfg)[0] - got[i]).abs().max()) for i in (3, 9, 15))
        power = melspectrogram(wav, cfg)[..., :-1]
        batch_max = (power_to_db(power, ref=1.0, amin=1e-10, top_db=80.0, utt_axes=3) / 10.0 + 4.0) / 4.0
        fault = float((batch_max.cpu() - want).abs().max())
        clipped = float((want[8:15] == want[8:15].amin(dim=(-2, -1), keepdim=True)).float().mean())
    log("whisper", part="log_mel", rows=16, err=f"{err:.3e}", alone_err=f"{alone:.3e}",
        batch_max_err=f"{fault:.3e}", padded_rows_at_clip=f"{clipped:.3f}", launches=counts["wave_mel"])
    if err > WHISPER_LOGMEL_TOL or alone > WHISPER_LOGMEL_TOL:
        raise AssertionError(f"whisper_log_mel: card vs CPU {err:.3e}, a row alone {alone:.3e} "
                             f"> {WHISPER_LOGMEL_TOL}")
    if fault < 100 * WHISPER_LOGMEL_TOL:
        raise AssertionError(f"whisper_log_mel: a batch-wide clip reads {fault:.3e}, too near the bound to be seen")
    del got, want, power, batch_max
    free()

    torch.cuda.reset_peak_memory_stats()
    model = init_whisper_mhfa(seed=0, device=DEVICE)
    score = make_whisper_mhfa_scorer(model)
    score(wav)  # warm: cuBLAS and the memory-efficient attention pick their kernels
    scores, counts = run_counted(lambda: score(wav))
    if counts["wave_mel"] != 1 or sum(counts.values()) != 1:
        raise AssertionError(f"make_whisper_mhfa_scorer: launches {counts}, want one wave_mel")
    if scores.shape != (16,) or not torch.isfinite(scores).all():
        raise AssertionError(f"make_whisper_mhfa_scorer: bad scores {scores}")
    ms = cuda_ms(lambda: score(wav), 3)
    log("whisper", part="scorer", batch=16, ms_per_call=f"{ms:.1f}", utt_per_s=f"{16e3 / ms:.2f}",
        launches=counts["wave_mel"], peak_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}")
    del model, score, wav, scores
    free()
    return {"wave_mel": 2}


def voxtral_rows(seed: int) -> torch.Tensor:
    """2 300-s clips on the CPU, ``whisper_rows``' recipe window by window
    at a level of its own (0.02-0.5), so a window's max differs from its
    clip's: clip 0 whole, clip 1 a 65-s clip zero-padded to 300 s, as
    ``cli score`` pads it."""
    g = torch.Generator().manual_seed(seed)
    rows = torch.cat([whisper_rows(seed + i).flatten()[:VOXTRAL_SAMPLES] for i in range(2)]).view(2, -1)
    wins = rows.view(2, 10, WHISPER_MHFA_SAMPLES)
    peaks = wins.abs().amax(dim=-1, keepdim=True).clamp_min(1e-30)
    levels = torch.logspace(math.log10(0.02), math.log10(0.5), 20)[torch.randperm(20, generator=g)].view(2, 10, 1)
    rows = (wins / peaks * levels).view(2, -1)
    rows[1, 65 * SR:] = 0.0
    return rows


def phase_voxtral() -> dict:
    """Voxtral-Mini-3B as a detector on the card, at the published widths
    and the voxtral-detect cell's shapes: the whole-clip log-mel in windows
    (``whisper_log_mel_windows``) of 2 300-s clips (``voxtral_rows``)
    against the plain chain on the CPU, its frames at the windows' edges
    apart, one ``wave_mel`` launch; a log-mel of each window alone misses
    by far more than the bound; then one ``make_voxtral_detect_scorer``
    call on those clips: exactly one K1 launch and no other hand-written
    kernel, 20 windows encoded and 7,540 decoder positions a call. Returns
    the launches."""
    cfg = WHISPER_LARGE_V3.mel
    frames = 2 * WHISPER_LARGE_V3.positions
    cpu_wav = voxtral_rows(31)
    wav = cpu_wav.to(DEVICE)
    with torch.inference_mode():
        got, counts = run_counted(lambda: whisper_log_mel_windows(wav, cfg, frames))
        if counts["wave_mel"] != 1 or sum(counts.values()) != 1:
            raise AssertionError(f"whisper_log_mel_windows: launches {counts}, want one wave_mel")
        want = whisper_log_mel_windows(cpu_wav, cfg, frames)
        if got.shape != (2, 10, cfg.n_mels, frames) or want.shape != got.shape:
            raise AssertionError(f"whisper_log_mel_windows: shape {tuple(got.shape)}")
        diff = (got.cpu() - want).abs()
        err = float(diff.max())
        edge = float(diff[..., [0, 1, 2, -3, -2, -1]].max())  # the frames whose DFT rows cross a window edge
        alone = whisper_log_mel(cpu_wav.view(20, WHISPER_MHFA_SAMPLES), cfg).view(2, 10, cfg.n_mels, frames)
        fault = float((alone - want).abs().max())
    log("voxtral", part="log_mel", clips=2, windows=20, err=f"{err:.3e}", edge_err=f"{edge:.3e}",
        per_window_err=f"{fault:.3e}", launches=counts["wave_mel"])
    if err > WHISPER_LOGMEL_TOL:
        raise AssertionError(f"whisper_log_mel_windows: card vs CPU {err:.3e} > {WHISPER_LOGMEL_TOL}")
    if fault < 100 * WHISPER_LOGMEL_TOL:
        raise AssertionError(f"whisper_log_mel_windows: a log-mel of each window alone reads {fault:.3e}, "
                             "too near the bound to be seen")
    del got, want, alone, diff
    free()

    torch.cuda.reset_peak_memory_stats()
    model = init_voxtral_detect(seed=0, device=DEVICE)
    score = make_voxtral_detect_scorer(model)
    score(wav)  # warm: cuBLAS and the memory-efficient attention pick their kernels
    reset_work_counts()
    scores, counts = run_counted(lambda: score(wav))
    work = work_counts()
    if counts["wave_mel"] != 1 or sum(counts.values()) != 1:
        raise AssertionError(f"make_voxtral_detect_scorer: launches {counts}, want one wave_mel")
    if work != {"voxtral.calls": 1, "voxtral.windows": 20, "voxtral.positions": 2 * 3770}:
        raise AssertionError(f"make_voxtral_detect_scorer: work counts {work}")
    if scores.shape != (2,) or not torch.isfinite(scores).all():
        raise AssertionError(f"make_voxtral_detect_scorer: bad scores {scores}")
    ms = cuda_ms(lambda: score(wav), 2)
    log("voxtral", part="scorer", clips=2, ms_per_call=f"{ms:.1f}", clips_per_s=f"{2e3 / ms:.3f}",
        launches=counts["wave_mel"], windows=work["voxtral.windows"], positions=work["voxtral.positions"],
        peak_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}")
    del model, score, wav, scores
    free()
    return {"wave_mel": 2}


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
    if counts["lstm_scan"] != 2:  # layer 1's two directions in one launch, layer 2's forward scan
        raise AssertionError(f"fused: {counts['lstm_scan']} K4 launches a call, not 2")
    if counts["cqcc"] != 1:  # the frontend: K5, raw waveform to CQCC
        raise AssertionError(f"fused: {counts['cqcc']} K5 launches a call, not 1")
    if expect_launched(counts, "gmm_llr", "fused") != 1:  # the GMM arm: K6, mask to masked mean
        raise AssertionError(f"fused: {counts['gmm_llr']} K6 launches a call, not 1")
    with torch.inference_mode():
        _, front_ms, front = device_breakdown(lambda: cqcc(wav, cfg), iters=3)
    front_names = [name for _, _, name in front]
    log("fused", frontend_device_ms=f"{front_ms:.3f}", frontend_kernels=json.dumps(front_names))
    if len(front_names) != 1 or "cqcc" not in front_names[0]:  # no CQT SGEMM, cat or copy left
        raise AssertionError(f"fused: the frontend ran {front_names}, not K5 alone")
    model_c, g_c, s_c = fused_models("cpu")
    cpu = make_cqcc_fused_scorer(model_c, g_c, s_c, cfg, scaler_mean=scaler.mean, scaler_std=scaler.std)
    diff = float((scores[:256].cpu() - cpu(wav[:256].cpu())).abs().max())
    if diff > FUSED_TOL:
        raise AssertionError(f"fused: card scores differ from the CPU's by {diff:.3e} > {FUSED_TOL}")
    ms = cuda_ms(lambda: score(wav), 3)
    # the benchmark's yardstick (mfu.score's): what the mathematics needs, by stage
    bench_cfg = json.loads((ROOT / "portbench" / "configs" / "cqcc-fused.json").read_text())
    flop = {k: BATCH * f(bench_cfg) for k, f in (("cqcc", cqcc_ops), ("bilstm", bilstm_classifier_ops),
                                                  ("gmm", gmm_pair_ops))}
    log("fused", batch=BATCH, **{f"gflop_{k}": f"{v / 1e9:.1f}" for k, v in flop.items()},
        tflops=f"{sum(flop.values()) / ms / 1e9:.2f}")
    log("fused", batch=BATCH, cqcc=f"{cfg.cqt.n_bins}bins/hop{cfg.cqt.hop_length}/{cfg.n_ceps}ceps",
        gmm_components=g.n_components, bilstm_hidden=128, lstm_scan_launches_per_call=counts["lstm_scan"],
        cqcc_launches_per_call=counts["cqcc"], gmm_llr_launches_per_call=counts["gmm_llr"],
        kernel_launches=json.dumps(counts, separators=(",", ":")),
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
    return {"ms": ms, "utt_per_s": BATCH / ms * 1e3, "diff_vs_cpu": diff, "lstm_scan": counts["lstm_scan"],
            "cqcc": counts["cqcc"], "gmm_llr": counts["gmm_llr"]}


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
    n_fft 2048 / hop 512) and the cqcc feature K5; the rest ran on XLA in
    the JAX package, so it is plain PyTorch here (cuBLAS, cuDNN, elementwise
    passes)."""
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
            elif name == "cqcc":  # K5: the whole CQCC in one launch
                if counts != {**dict.fromkeys(counts, 0), "cqcc": 1}:
                    raise AssertionError(f"features cqcc: launched {counts}, not one K5 launch")
            elif any(counts.values()):
                raise AssertionError(f"features {name}: launched {counts}, no kernel is on its path")
            if out.device.type != torch.device(DEVICE).type or out.shape[0] != BATCH or not bool(torch.isfinite(out).all()):
                raise AssertionError(f"features {name}: {tuple(out.shape)} on {out.device}, finite "
                                     f"{bool(torch.isfinite(out).all())}")
            ms = cuda_ms(lambda: fn(wav), 3)
            err = feature_error(out[:256].cpu(), fn(wav_cpu))
            log("features", name=name, batch=BATCH, shape="x".join(map(str, out.shape[1:])),
                ct_mel_launches=counts["ct_mel"], cqcc_launches=counts["cqcc"], ms=f"{ms:.3f}",
                utt_per_s=f"{BATCH / ms * 1e3:.1f}",
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


# Phase 13: the multi-process server (a), data parallelism at world size 1
# over NCCL (b), the component-sharded GMM llr at the fused scorer's widths
# (c), the multi-rank dry run (d) and (b)/(c) on 2 gloo ranks sharing the
# card (e). Serving traffic: MULTI_CLIENTS threads, each sending
# MULTI_REQUESTS requests of MULTI_ROWS 2-s rows to /v1/score_raw, every
# MULTI_PCM_EVERY-th of them one row as a JSON ``pcm`` list instead.
MULTI_WORKERS = (2, 4)
MULTI_MAX_BATCH = 256  # the owner's batcher, as phase 7's
MULTI_CLIENTS, MULTI_REQUESTS, MULTI_ROWS, MULTI_PCM_EVERY = 16, 12, 4, 6
DP_ROWS, DP_EPOCHS = 2048, 2
# fit(data_parallel=True) against the single-process fit on the card, from
# one init on the same batches (dropout 0, Adam 1e-4): the epoch losses and
# the BatchNorm running statistics at phase 10's card-vs-CPU bounds (the
# sync-BN forward normalizes by (x - E[x]) rsqrt(E[x^2] - E[x]^2 + eps),
# flax's arithmetic, where the single step runs cuDNN's batch norm), the
# parameters at the JAX package's DP bounds (tests/test_train.py:113-117),
# but those whose gradient is zero in exact arithmetic (the conv bias under
# the BatchNorm, the softmax attention's bias), which Adam random-walks by
# up to lr a step, at lr times the steps
DP_PARAM_RTOL, DP_PARAM_ATOL = 1e-2, 1e-4
DP_NULL_GRAD = ("conv.bias", "attention.bias")
# the sharded llr at the fused scorer's widths (two 128-component GMMs of
# 19 dims, B=8192 x 63 frames) against masked_llr, relative to the largest
# |llr|: the component logsumexp split into a max and a sum over the model
# ranks, fp32
LLR_B, LLR_T, LLR_D, LLR_K = 8192, 63, 19, 128
SHARDED_LLR_RTOL = 1e-5


def compute_apps() -> list[tuple[int, str]]:
    """(pid, used memory) of every process nvidia-smi lists as holding a
    CUDA context (processes of other PID namespaces may not be listed)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout
    return [(int(line.split(",")[0]), line.split(",")[1].strip()) for line in out.splitlines() if line.strip()]


def holds_card(pid: int) -> bool:
    """Whether process ``pid`` has a card's device file open (a CUDA
    context opens /dev/nvidia*; importing torch opens none)."""
    fd_dir = f"/proc/{pid}/fd"
    for fd in os.listdir(fd_dir):
        try:
            if os.readlink(os.path.join(fd_dir, fd)).startswith("/dev/nvidia"):
                return True
        except OSError:  # the descriptor closed meanwhile
            continue
    return False


def _get_json(url: str) -> dict:
    with urllib.request.urlopen(url, timeout=60) as resp:
        return json.loads(resp.read())


def multi_traffic(base: str, direct, seed: int) -> dict:
    """Drive (a)'s traffic at the service on ``base`` and hold every score
    to ``direct``: utt/s, latency percentiles, the stats' delta, and K3's
    launches under the traffic: this process's (every counter set to 0
    just before it and read just after it, before the check's own calls)
    and the owner's, where the service reports them. Kept beside
    ``portbench/harness/openloop.py``, which paces seeded Poisson arrivals
    for a latency tail: these clients send back to back, for the rate."""
    rng = np.random.default_rng(seed)
    requests = []  # per client: (rows, body, headers, path)
    for _ in range(MULTI_CLIENTS):
        mine = []
        for i in range(MULTI_REQUESTS):
            if i % MULTI_PCM_EVERY == MULTI_PCM_EVERY - 1:
                rows = (rng.standard_normal((1, N_SAMPLES)) * 0.1).astype(np.float32)
                mine.append((rows, json.dumps({"pcm": rows.tolist()}).encode(),
                             {"Content-Type": "application/json"}, "/v1/score"))
            else:
                rows = (rng.standard_normal((MULTI_ROWS, N_SAMPLES)) * 0.1).astype(np.float32)
                mine.append((rows, rows.astype("<f4").tobytes(),
                             {"Content-Type": "application/octet-stream", "X-Rows": str(MULTI_ROWS)},
                             "/v1/score_raw"))
        requests.append(mine)
    results = [[None] * MULTI_REQUESTS for _ in range(MULTI_CLIENTS)]
    latency: list[float] = []

    def client(c: int) -> None:
        for i, (_, body, headers, path) in enumerate(requests[c]):
            t = time.perf_counter()
            try:
                results[c][i] = _post(base + path, body, headers)
            except urllib.error.HTTPError as e:  # held below with its body
                results[c][i] = (e.code, {"error": e.read().decode(errors="replace")})
            latency.append(time.perf_counter() - t)

    stats0 = _get_json(base + "/v1/stats")
    threads = [threading.Thread(target=client, args=(c,)) for c in range(MULTI_CLIENTS)]
    reset_launch_counts()
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    wall = time.perf_counter() - t0
    here = launch_counts()["ct_mel"]
    stats1 = _get_json(base + "/v1/stats")
    if any(t.is_alive() for t in threads) or any(r is None for rs in results for r in rs):
        raise AssertionError(f"multi serve at {base}: a request did not complete")
    failed = [r for rs in results for r in rs if r[0] != 200]
    if failed:
        raise AssertionError(f"multi serve at {base}: {len(failed)} requests failed, first {failed[:3]}")
    worst, n_rows = 0.0, 0
    for c in range(MULTI_CLIENTS):
        for (rows, *_), (status, payload) in zip(requests[c], results[c]):
            worst = max(worst, float(np.abs(np.asarray(payload["scores"]) - direct(rows)).max()))
            n_rows += len(rows)
    if worst > SERVE_TOL:
        raise AssertionError(f"multi serve at {base}: scores {worst:.3e} from the direct scorer")
    served = stats1["utterances"] - stats0["utterances"]
    if served != n_rows:
        raise AssertionError(f"/v1/stats counted {served} utterances of {n_rows} sent")
    p50, p99, worst_ms = np.percentile(np.asarray(latency) * 1e3, [50, 99, 100])
    out = {"requests": MULTI_CLIENTS * MULTI_REQUESTS, "rows": n_rows, "clients": MULTI_CLIENTS,
           "wall_s": f"{wall:.3f}", "utt_per_s": f"{n_rows / wall:.1f}", "p50_ms": f"{p50:.3f}",
           "p99_ms": f"{p99:.3f}", "max_ms": f"{worst_ms:.3f}", "max_diff_vs_direct": f"{worst:.3e}", "stats_utterances": served,
           "stats_batches": stats1["batches"] - stats0["batches"], "mean_batch_fill": stats1["mean_batch_fill"],
           "ct_mel_launches_here": here}
    if "kernel_launches" in stats1:
        out["owner_ct_mel_launches"] = stats1["kernel_launches"]["ct_mel"] - stats0["kernel_launches"]["ct_mel"]
    return out


def dispatch_card_ms(direct) -> dict:
    """{bucket: (host wall ms, card ms, launches)} of one dispatch of
    ``direct`` at each bucket of (a)'s ladder (``device_breakdown``: its
    kernels and its rows' copy to the card): the owner's work per batch,
    as its batcher pads a batch to its bucket."""
    rng = np.random.default_rng(31)
    out = {}
    for b in default_bucket_ladder(MULTI_MAX_BATCH):
        rows = (rng.standard_normal((b, N_SAMPLES)) * 0.1).astype(np.float32)
        wall, card, ranked = device_breakdown(lambda: direct(rows), top=10**6)
        out[b] = (wall, card, sum(n for _, n, _ in ranked))
        log("multi", part="a", dispatch_rows=b, wall_ms=f"{wall:.3f}", card_ms=f"{card:.3f}",
            launches=out[b][2])
    return out


def card_share(traffic: dict, card: dict) -> dict:
    """The card's time (kernels and copies) under (a)'s traffic over its
    wall: bounded by its batches all at the smallest and all at the largest
    bucket, and estimated at the mean dispatch (the rows over the batch
    fill, per batch) on the line through ``card``'s buckets."""
    buckets = sorted(card)
    per = [card[b][1] for b in buckets]
    batches = traffic["stats_batches"]
    mean_rows = traffic["rows"] / traffic["mean_batch_fill"] / batches
    wall_ms = float(traffic["wall_s"]) * 1e3
    out = {"mean_dispatch_rows": f"{mean_rows:.1f}"}
    for name, ms in (("lo", min(per)), ("hi", max(per)), ("est", float(np.interp(mean_rows, buckets, per)))):
        out[f"card_ms_{name}"] = f"{batches * ms:.3f}"
        out[f"busy_{name}"] = f"{batches * ms / wall_ms:.4f}"
    return out


def multi_serve_single(direct) -> tuple[int, dict]:
    """(a)'s traffic at the single-process ScoreServer (phase 7's service,
    in this process): the baseline; returns its K3 launches and
    ``dispatch_card_ms``."""
    batcher = BatchingScorer(direct, n_samples=N_SAMPLES, max_batch=MULTI_MAX_BATCH,
                             bucket_sizes=default_bucket_ladder(MULTI_MAX_BATCH))
    batcher.warm_up()
    server = ScoreServer(batcher, sr=SR, host="127.0.0.1", port=0)
    server.start_background()
    try:
        traffic = multi_traffic(f"http://127.0.0.1:{server.port}", direct, 30)
    finally:
        server.close()
    card = dispatch_card_ms(direct)
    log("multi", part="a", workers=1, **traffic, **card_share(traffic, card))
    launches = expect_launched({"ct_mel": traffic["ct_mel_launches_here"]}, "ct_mel", "the single-process service")
    return launches, card


def multi_serve(workers: int, checkpoint: str, direct, card: dict) -> int:
    """(a) for one worker count: the owner runs the parity scorer (K3 on
    every batch); returns the owner's K3 launches during the traffic."""
    apps_before = compute_apps()
    srv = MultiprocessServer(
        workers=workers, sr=SR,
        factory_kwargs=dict(checkpoint=checkpoint, sr=SR, seconds=N_SAMPLES / SR, mel_profile="parity",
                            device=DEVICE),
        batcher_kwargs=dict(max_batch=MULTI_MAX_BATCH, bucket_sizes=default_bucket_ladder(MULTI_MAX_BATCH)),
    )
    t0 = time.perf_counter()
    srv.start()
    start_s = time.perf_counter() - t0
    try:
        traffic = multi_traffic(f"http://127.0.0.1:{srv.port}", direct, 30 + workers)
        apps = compute_apps()
        pids = srv.pids
        workers_hold = [holds_card(p) for p in pids["workers"]]
        owner_holds = holds_card(pids["owner"])
    finally:
        srv.close()
    log("multi", part="a", workers=workers, **traffic, **card_share(traffic, card), start_s=f"{start_s:.1f}",
        owner_holds_card=owner_holds, workers_hold_card=",".join(map(str, workers_hold)),
        smi_apps_before=len(apps_before), smi_apps=",".join(f"{pid}:{mem.replace(' ', '')}" for pid, mem in apps),
        owner_pid=pids["owner"], worker_pids=",".join(map(str, pids["workers"])))
    launches = expect_launched({"ct_mel": traffic["owner_ct_mel_launches"]}, "ct_mel",
                               f"the owner under {workers} workers' traffic")
    if traffic["ct_mel_launches_here"]:
        raise AssertionError(f"this process launched K3 under the {workers} workers' traffic")
    if any(workers_hold) or not owner_holds:
        raise AssertionError(f"card held by workers {workers_hold}, owner {owner_holds}")
    listed = {pid for pid, _ in apps}
    if listed & set(pids["workers"]):
        raise AssertionError(f"nvidia-smi lists a worker holding a CUDA context: {apps}")
    return launches


def dp_models(T: int, axis: str | None) -> CNNBiLSTMHybrid:
    return flax_init_(CNNBiLSTMHybrid(T, logits=True, fixed_attention=True, dropout_rate=0.0, conv_dropout=0.0,
                                      bn_axis_name=axis), torch.Generator().manual_seed(0))


def dp_features(seed: int = 21) -> tuple[torch.Tensor, torch.Tensor, int]:
    """(parity log-mel of DP_ROWS utterances through K3, labels, K3 launches)."""
    wav, y = train_corpus(DP_ROWS, seed)

    def features():
        with torch.no_grad():
            return log_mel_spectrogram(wav, MelConfig.for_profile("parity", SR))

    feats, counts = run_counted(features)
    return feats, y, expect_launched(counts, "ct_mel", "multi dp features")


def dp_fit(feats: torch.Tensor, y: torch.Tensor, data_parallel: bool):
    state = TrainState.create(model=dp_models(feats.shape[-1], "data" if data_parallel else None).to(DEVICE),
                              tx=make_optimizer("Adam", 1e-4))
    split = int(DP_ROWS * 0.8)
    return fit(state, (feats[:split], y[:split]), (feats[split:], y[split:]), loss_name="BCELoss",
               num_epochs=DP_EPOCHS, batch_size=TRAIN_BATCH, binary_head=True, plots=False,
               data_parallel=data_parallel)


def dp_compare(logs: list, sd: dict, steps: int, single) -> dict:
    """A data-parallel fit (its epochs' (train loss, val loss), its model's
    state_dict and its step count) against the single-process ``single``."""
    want_logs = [(r.train_loss, r.val_loss) for r in single.logs]
    loss = max(abs(a / b - 1) for got, want in zip(logs, want_logs) for a, b in zip(got, want))
    ref = {k: v.detach().cpu() for k, v in single.state.model.state_dict().items()}
    bn = max(float((sd[k].cpu() - ref[k]).abs().max() / ref[k].abs().max())
             for k in ("bn.running_mean", "bn.running_var"))
    worst_param, worst_null = 0.0, 0.0
    for k, _ in single.state.model.named_parameters():
        d = (sd[k].detach().cpu() - ref[k]).abs()
        if k in DP_NULL_GRAD:
            worst_null = max(worst_null, float(d.max()))
        else:
            worst_param = max(worst_param, float((d - DP_PARAM_RTOL * ref[k].abs()).max()))
    out = {"loss_rel_diff": loss, "bn_rel_diff": bn, "param_excess": worst_param, "null_grad_diff": worst_null,
           "steps": steps}
    if (loss > TRAIN_LOSS_RTOL or bn > TRAIN_BN_RTOL or worst_param > DP_PARAM_ATOL
            or worst_null > 1e-4 * single.state.step or steps != single.state.step):
        raise AssertionError(f"data-parallel fit against the single one: {out}")
    return out


def _fmt(d: dict) -> dict:
    return {k: (f"{v:.3e}" if isinstance(v, float) else v) for k, v in d.items()}


def sharded_llr_check(mesh) -> dict:
    """(c): the component-sharded llr of this rank's rows against
    masked_llr, and both times in turns."""
    g = torch.Generator(device=DEVICE).manual_seed(23)

    def gmm() -> DiagGMM:
        return DiagGMM(weights=torch.softmax(torch.randn(LLR_K, generator=g, device=DEVICE), 0),
                       means=torch.randn((LLR_K, LLR_D), generator=g, device=DEVICE),
                       variances=torch.rand((LLR_K, LLR_D), generator=g, device=DEVICE) + 0.5)

    g1, g2 = gmm(), gmm()
    x = torch.randn((LLR_B, LLR_T, LLR_D), generator=g, device=DEVICE)
    lengths = torch.randint(LLR_T // 2, LLR_T + 1, (LLR_B, 1), generator=g, device=DEVICE)
    mask = torch.arange(LLR_T, device=DEVICE) < lengths
    x, mask = shard_batch((x, mask), mesh, axis="data")
    sharded = make_sharded_masked_llr(mesh, g1, g2)
    with torch.no_grad():
        got, ref = sharded(x, mask), masked_llr(x, mask, g1, g2)
        t = in_turns(lambda: sharded(x, mask), lambda: masked_llr(x, mask, g1, g2))
    rel = float((got - ref).abs().max() / ref.abs().max())
    if not bool(torch.isfinite(got).all()) or rel > SHARDED_LLR_RTOL:
        raise AssertionError(f"sharded llr: rel diff {rel:.3e} > {SHARDED_LLR_RTOL}")
    return {"rel_diff": rel, "ms": t["ms"], "plain_ms": t["plain_ms"], "rows": len(x)}


def _gloo_rank(rank: int, world: int, init_method: str, out_dir: str) -> None:
    """(e): one of 2 gloo ranks sharing the card: the data-parallel fit and
    the sharded llr on a (1 data x 2 model) mesh."""
    import pickle

    import torch.distributed as dist

    # gloo over CUDA tensors: NCCL refuses two ranks on one card
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=init_method, world_size=world, rank=rank)
    try:
        try:
            probe = torch.ones(1, device=DEVICE)
            dist.all_reduce(probe)
        except RuntimeError as e:  # this torch build's gloo takes no CUDA tensors
            result = {"gloo_cuda": False, "error": f"{type(e).__name__}: {e}"}
        else:
            feats, y, launches = dp_features()
            res = dp_fit(feats, y, True)
            result = {"gloo_cuda": True, "launches": launches,
                      "logs": [(r.train_loss, r.val_loss) for r in res.logs], "steps": res.state.step,
                      "sd": {k: v.cpu() for k, v in res.state.model.state_dict().items()},
                      "llr": sharded_llr_check(make_mesh_2d(1, world))}
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def multi_gloo(single) -> None:
    """(e): spawn 2 gloo ranks on the card; hold their fit to ``single``."""
    import multiprocessing as mp
    import pickle

    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as d:
        procs = [ctx.Process(target=_gloo_rank, args=(r, 2, "file://" + os.path.join(d, "rdzv"), d))
                 for r in range(2)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        deadline = time.monotonic() + 600
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        codes = [p.exitcode for p in procs]
        if codes != [0, 0]:
            raise AssertionError(f"gloo ranks exited with {codes}")
        results = []
        for r in range(2):
            with open(os.path.join(d, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    wall = time.perf_counter() - t0
    if not results[0]["gloo_cuda"]:
        log("multi", part="e", ran=False, reason=results[0]["error"][:200].replace(" ", "_"))
        return

    for rank, r in enumerate(results):
        cmp = dp_compare(r["logs"], r["sd"], r["steps"], single)
        log("multi", part="e", ran=True, rank=rank, ranks=2, backend="gloo", wall_s=f"{wall:.1f}",
            ct_mel_launches=r["launches"], **_fmt(cmp), llr_rel_diff=f"{r['llr']['rel_diff']:.3e}",
            llr_rows=r["llr"]["rows"], llr_ms=f"{r['llr']['ms']:.3f}", llr_plain_ms=f"{r['llr']['plain_ms']:.3f}")


def phase_multi() -> dict:
    """Phase 13; returns the K3 launches of its main paths (the owner's
    under traffic and the data-parallel features)."""
    import torch.distributed as dist

    cfg = MelConfig.for_profile("parity", SR)
    launches = 0
    with tempfile.TemporaryDirectory() as d:
        checkpoint = random_checkpoint(d, cfg)
        direct, _ = build_mel_scorer(checkpoint=checkpoint, sr=SR, seconds=N_SAMPLES / SR, device=DEVICE)
        n, card = multi_serve_single(direct)
        launches += n
        for workers in MULTI_WORKERS:
            launches += multi_serve(workers, checkpoint, direct, card)

    with tempfile.TemporaryDirectory() as d:
        initialize_distributed("file://" + os.path.join(d, "rdzv"), 1, 0, device=DEVICE)
        try:
            # (b) fit(data_parallel=True) at world size 1 over NCCL
            feats, y, n = dp_features()
            launches += n
            t0 = time.perf_counter()
            single = dp_fit(feats, y, False)
            t1 = time.perf_counter()
            dp = dp_fit(feats, y, True)
            t2 = time.perf_counter()
            cmp = dp_compare([(r.train_loss, r.val_loss) for r in dp.logs], dp.state.model.state_dict(),
                             dp.state.step, single)
            mesh = make_mesh(1)
            states = [TrainState.create(model=dp_models(feats.shape[-1], a).to(DEVICE), tx=make_optimizer("Adam", 1e-4))
                      for a in (None, "data")]
            single_step = make_train_step(get_loss("BCELoss"), binary_head=True)
            dp_step = make_dp_train_step(get_loss("BCELoss"), mesh, binary_head=True)
            xb, yb = feats[:TRAIN_BATCH].contiguous(), y[:TRAIN_BATCH].contiguous()
            g = torch.Generator(device=DEVICE).manual_seed(0)
            t = in_turns(lambda: dp_step(states[1], xb, yb, g), lambda: single_step(states[0], xb, yb, g), iters=20)
            # one step's kernels and launches, each step alone (torch.profiler)
            steps = {name: device_breakdown(fn, top=10**6) for name, fn in (
                ("dp", lambda: dp_step(states[1], xb, yb, g)), ("single", lambda: single_step(states[0], xb, yb, g)))}
            for name, (wall, card, ranked) in steps.items():
                log("multi", part="b", step=name, wall_ms=f"{wall:.3f}", card_ms=f"{card:.3f}",
                    launches=sum(n for _, n, _ in ranked), nccl_ms=f"{sum(ms for ms, _, k in ranked if 'nccl' in k.lower()):.3f}")
            log("multi", part="b", backend=dist.get_backend(), world=dist.get_world_size(), rows=DP_ROWS,
                epochs=DP_EPOCHS, batch=TRAIN_BATCH, ct_mel_launches=n, single_fit_s=f"{t1 - t0:.3f}",
                dp_fit_s=f"{t2 - t1:.3f}", dp_step_ms=f"{t['ms']:.3f}", single_step_ms=f"{t['plain_ms']:.3f}",
                train_loss=",".join(f"{r.train_loss:.6f}" for r in dp.logs), **_fmt(cmp))
            # (c) the component-sharded llr on a (1 x 1) mesh
            llr = sharded_llr_check(make_mesh_2d(1, 1))
            log("multi", part="c", world=1, batch=LLR_B, frames=LLR_T, dim=LLR_D, components=LLR_K,
                rel_diff=f"{llr['rel_diff']:.3e}", ms=f"{llr['ms']:.3f}", plain_ms=f"{llr['plain_ms']:.3f}")
        finally:
            dist.destroy_process_group()
    del feats, xb, yb, states
    free()

    # (d) the dry run: one NCCL rank on the card, in a process of its own
    t0 = time.perf_counter()
    dryrun_multichip(1)
    log("multi", part="d", ranks=1, wall_s=f"{time.perf_counter() - t0:.1f}")

    # (e) (b) and (c) again on 2 gloo ranks sharing the card
    multi_gloo(single)
    return {"ct_mel": launches}


# Phase 14, card against CPU from the same converted weights (first-run
# bands, each reading kept in PERF.md): eval logits relative to the largest
# logit and a train step's loss relative to itself, fp32 convolutions
# (cuDNN, TF32 off, against oneDNN) summed in other orders through 13-52
# layers (the CPU tests read 2.3e-5 between the port in fp32 and float64
# on MobileNet); the BatchNorm running statistics after that one step
# relative to each layer's largest entry (the flax-rule variance
# E[x^2] - E[x]^2 cancels in fp32, TRAIN_BN_RTOL's reasoning)
MODEL_RTOL = 1e-4
MODEL_BN_RTOL = 2e-3
# attribution maps relative to each map's largest entry: gradients and
# score drops of those fp32 logits (the CPU tests hold the port to JAX at
# 1e-4 on ResNet maps); LIME's surrogate coefficients relative to the
# largest, from the same masks (one CPU generator) and scores ~1e-6 apart
XAI_RTOL = 1e-3
# integrated gradients sum gradients at 20 scaled copies of the input, and
# where a unit's pre-activation falls within rounding of LeakyReLU's kink
# the two devices take different slopes there: the CPU alone, in float32
# against float64, reads 4.1e-3 of the map's largest entry on 47 of 4032
# cells of one utterance in four (3e-7 on the others), an H100 against the
# CPU 7.8e-3. So IG is held by the L2 norm of the difference relative to
# the map's (CPU, float32 against float64: 1.1e-3 on that utterance)
IG_L2_RTOL = 1e-2
# the CLIs' best checkpoints scored on the card and on the CPU, the same
# features: logits relative to the largest
CLI_SCORE_RTOL = 1e-4
MODEL_BATCH, MODEL_CPU_ROWS, MODEL_STEP_ROWS = 256, 64, 32
XAI_IG_STEPS, XAI_LIME = 20, 30
OCC_CHECK_ROWS = (0, 31, 63)  # mel rows of the occlusion map the CPU recomputes


def model_zoo() -> dict:
    """name -> (constructor from the converted random weights, input builder
    from the phase's features). Dropout rates are set to 0 in place, so card
    and CPU steps take the same path."""
    from audioanalysisdetector_tpu_torch.models.layers import Dropout

    def build(cls, variables):
        def make():
            m = cls()
            m.load_state_dict(flax_to_torch_resnet(variables))  # the rule of all three 2-D models
            for mod in m.modules():
                if isinstance(mod, Dropout):
                    mod.rate = 0.0
            return m
        return make

    return {
        "resnet": (build(AntiSpoofingResNet, random_flax_resnet(140)), lambda f: (f["logmel"],)),
        "more_features": (build(MoreFeaturesClassifier, random_flax_more_features(141)),
                          lambda f: (f["cqcc"], f["gfcc"], f["mfcc"])),
        "mobilenet_mfca": (build(MobileNetMFCA, random_flax_mobilenet_mfca(142)), lambda f: (f["logmel"],)),
    }


def model_features(wav: torch.Tensor) -> tuple[dict, int]:
    """Log-mel at 64 mels (K3), CQCC, GFCC and MFCC (128 mels, K3) of the
    batch on the card, as ``train-mfca`` / ``train-3features`` make them;
    returns them and K3's launches."""
    from audioanalysisdetector_tpu_torch.frontend.cepstral import CepstralConfig, gfcc
    from audioanalysisdetector_tpu_torch.frontend.mfcc import mfcc

    def features():
        with torch.no_grad():
            return {"logmel": log_mel_spectrogram(wav, MelConfig(sr=SR, n_mels=64)),
                    "cqcc": cqcc(wav, CQCCConfig.for_sr(SR)),
                    "gfcc": gfcc(wav, CepstralConfig(fs=SR, nfilts=40, fb_kind="gammatone")),
                    "mfcc": mfcc(wav, MFCCConfig.for_sr(SR))}

    feats, counts = run_counted(features)
    n = expect_launched(counts, "ct_mel", "model features")
    for k, f in feats.items():
        if not bool(torch.isfinite(f).all()):
            raise AssertionError(f"model features: {k} not finite")
    return feats, n


def model_card_vs_cpu(name: str, make, inputs: tuple, y: torch.Tensor) -> dict:
    """Eval logits at MODEL_BATCH on the card against the CPU's first
    MODEL_CPU_ROWS rows; one train step (the sweep's Adam) on MODEL_STEP_ROWS
    rows on both: loss and every BatchNorm's running statistics; ms per
    forward and per step at MODEL_BATCH (CUDA events) with the kernels one
    step launches (``device_breakdown``)."""
    card, host = make().to(DEVICE).eval(), make().eval()
    with torch.no_grad():
        logits = card(*inputs)
        ref = host(*(x[:MODEL_CPU_ROWS].cpu() for x in inputs))
    if logits.shape != (MODEL_BATCH, 2) or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{name}: logits {tuple(logits.shape)} or non-finite")
    fwd_rel = float((logits[:MODEL_CPU_ROWS].cpu() - ref).abs().max() / ref.abs().max())
    losses, stats = [], []
    for model in (make().to(DEVICE), make()):
        device = next(model.parameters()).device
        state = TrainState.create(model=model, tx=make_optimizer("Adam", 1e-4))
        step = make_train_step(get_loss("CrossEntropyLoss"))
        rows = tuple(x[:MODEL_STEP_ROWS].to(device) for x in inputs)
        state, m = step(state, rows if len(rows) > 1 else rows[0], y[:MODEL_STEP_ROWS].to(device),
                        torch.Generator(device=device))
        losses.append(float(m["loss"]))
        stats.append({k: t.cpu() for k, t in model.state_dict().items() if "running_" in k})
    loss_rel = abs(losses[0] - losses[1]) / abs(losses[1])
    bn_rel = max(float((stats[0][k] - t).abs().max() / t.abs().max().clamp_min(1e-30)) for k, t in stats[1].items())
    # timing at MODEL_BATCH on the card
    with torch.no_grad():
        fwd_ms = cuda_ms(lambda: card(*inputs), 10)
    state = TrainState.create(model=make().to(DEVICE), tx=make_optimizer("Adam", 1e-4))
    step = make_train_step(get_loss("CrossEntropyLoss"))
    g = torch.Generator(device=DEVICE).manual_seed(0)
    xs = inputs if len(inputs) > 1 else inputs[0]
    for _ in range(2):
        step(state, xs, y, g)
    step_ms = cuda_ms(lambda: step(state, xs, y, g), 10)
    wall, busy, ranked = device_breakdown(lambda: step(state, xs, y, g), iters=3, top=10**6)
    out = {"fwd_rel_diff": fwd_rel, "loss_rel_diff": loss_rel, "bn_rel_diff": bn_rel, "fwd_ms": fwd_ms,
           "step_ms": step_ms, "step_launches": sum(n for _, n, _ in ranked), "busy_share": busy / wall}
    log("models", model=name, batch=MODEL_BATCH, inputs=",".join(str(tuple(x.shape[1:])) for x in inputs),
        params=sum(p.numel() for p in card.parameters()), loss=f"{losses[0]:.6f}",
        **{k: (f"{v:.3e}" if "rel" in k else f"{v:.3f}" if isinstance(v, float) else v) for k, v in out.items()},
        utt_per_s_train=f"{MODEL_BATCH / step_ms * 1e3:.1f}")
    for k_ms, k_n, k_name in ranked[:6]:
        print(f"  {k_ms:8.3f} ms  x{k_n}  {k_name[:100]}", flush=True)
    if fwd_rel > MODEL_RTOL or loss_rel > MODEL_RTOL or bn_rel > MODEL_BN_RTOL:
        raise AssertionError(f"{name}: card vs CPU logits {fwd_rel:.3e}, loss {loss_rel:.3e}, BN {bn_rel:.3e}")
    return out


def xai_card_vs_cpu(feats: dict) -> dict:
    """Saliency, IG, occlusion (1, 5), Grad-CAM and LIME of the ResNet on
    one utterance's log-mel, card against CPU; ms each on the card."""
    from audioanalysisdetector_tpu_torch import xai

    make = model_zoo()["resnet"][0]
    card, host = make().to(DEVICE).eval(), make().eval()
    x = feats["logmel"][:1].contiguous()
    xc = x.cpu()
    T = x.shape[-1]

    def scorer_of(m):
        return torch.no_grad()(lambda b: torch.softmax(m(b), dim=-1)[:, 1])

    methods = {
        "saliency": lambda m, v: xai.saliency(m, v),
        "integrated_gradients": lambda m, v: xai.integrated_gradients(m, v, steps=XAI_IG_STEPS),
        "grad_cam": lambda m, v: xai.grad_cam(m, v, output_size=tuple(v.shape[-2:])),
        "lime": lambda m, v: torch.from_numpy(
            xai.lime_single_instance(scorer_of(m), v[0], n_perturbations=XAI_LIME)["coefficients"]),
    }
    out = {}
    for name, fn in methods.items():
        got = fn(card, x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = fn(card, x)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        ref = fn(host, xc).double()
        diff = got.cpu().double() - ref
        rel = float(diff.abs().max() / ref.abs().max().clamp_min(1e-30))
        rel_l2 = float(diff.norm() / ref.norm().clamp_min(1e-30))
        out[name] = {"rel_diff": rel, "rel_l2": rel_l2, "ms": ms}
        log("xai", method=name, shape=tuple(got.shape), ms=f"{ms:.1f}", rel_diff=f"{rel:.3e}", rel_l2=f"{rel_l2:.3e}")
        ok = rel_l2 <= IG_L2_RTOL if name == "integrated_gradients" else rel <= XAI_RTOL
        if not ok:
            raise AssertionError(f"xai {name}: card vs CPU max {rel:.3e}, L2 {rel_l2:.3e}")
    # occlusion: the full map on the card (64 x 59 positions); the CPU
    # recomputes its rows OCC_CHECK_ROWS from those rows' windows
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    occ = xai.occlusion(card, x, window=(1, 5))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    n_pos = (x.shape[1]) * (T - 5 + 1)
    with torch.no_grad():
        base = host(xc)[0, 1]
        rows = []
        for r in OCC_CHECK_ROWS:
            occ_in = xc.repeat(T - 4, 1, 1)
            for f0 in range(T - 4):
                occ_in[f0, r, f0 : f0 + 5] = 0.0
            drops = (base - host(occ_in)[:, 1])[None, None, None]  # (1, 1, 1, n_f)
            heat = torch.nn.functional.conv2d(drops, torch.ones(1, 1, 1, 5), padding=(0, 4))[0, 0, 0]
            counts = torch.nn.functional.conv2d(torch.ones(1, 1, 1, T - 4), torch.ones(1, 1, 1, 5), padding=(0, 4))
            rows.append(heat / counts[0, 0, 0])
    ref = torch.stack(rows)
    got = occ[0, list(OCC_CHECK_ROWS)].cpu()
    rel = float((got - ref).abs().max() / occ.abs().max().cpu())
    out["occlusion"] = {"rel_diff": rel, "ms": ms}
    log("xai", method="occlusion", window="1x5", positions=n_pos, ms=f"{ms:.1f}", rows_checked=len(OCC_CHECK_ROWS),
        rel_diff=f"{rel:.3e}")
    if not rel <= XAI_RTOL:
        raise AssertionError(f"xai occlusion: card vs CPU rows {rel:.3e} > {XAI_RTOL}")
    return out


def xai_compare_card_vs_cpu() -> dict:
    """``compare_gmm_bilstm`` at the fused widths (BiLSTM hidden 128, two
    128-component GMMs, T 63, F 19) on the card and on the CPU: its IG runs
    the gradient through cuDNN's LSTM (its LSTMs in training mode)."""
    from audioanalysisdetector_tpu_torch import xai

    v = random_flax_bilstm_classifier(143, 128, 19)
    gmms = [random_diag_gmm(144 + i, GMM_K, 19) for i in range(2)]
    x = np.random.default_rng(146).standard_normal((63, 19)).astype(np.float32)
    outs, ms = [], 0.0
    for device in (DEVICE, "cpu"):
        m = BiLSTMClassifier(hidden=128, input_dim=19)
        m.load_state_dict(flax_to_torch_bilstm_classifier(v))
        m = m.to(device).eval()
        g1, g2 = (from_numpy(g, device=device) for g in gmms)

        def gmm_score(batch, g1=g1, g2=g2):
            with torch.no_grad():
                return torch.sigmoid(masked_llr(batch, torch.ones(batch.shape[:-1], dtype=torch.bool,
                                                                  device=batch.device), g1, g2))

        t0 = time.perf_counter()
        outs.append(xai.compare_gmm_bilstm(x, bilstm_model=m, gmm_score_fn=gmm_score))
        if device == DEVICE:
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        if m.training or any(mod.training for mod in m.modules()):
            raise AssertionError("compare_gmm_bilstm left a module in training mode")
    rel = {}
    for part in ("heatmaps", "importance"):
        for k, ref in outs[1][part].items():
            got = outs[0][part][k]
            if got.shape != ref.shape or not np.isfinite(got).all():
                raise AssertionError(f"compare {k}: shape {got.shape} vs {ref.shape} or non-finite")
            rel[k] = float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))
    log("xai", method="compare_gmm_bilstm", hidden=128, components=GMM_K, frames=63, dims=19, ms=f"{ms:.1f}",
        **{f"{k}_rel_diff": f"{r:.3e}" for k, r in rel.items()})
    if max(rel.values()) > XAI_RTOL:
        raise AssertionError(f"compare_gmm_bilstm: card vs CPU {rel}")
    return {"ms": ms, "rel_diff": max(rel.values())}


def models_cli(d: str) -> int:
    """``xai`` (all five methods, ``--html``) over a WAV made on the card,
    then ``train-mfca`` and ``train-3features`` for 2 epochs over 16 labelled
    WAVs, in this process on the card; each best checkpoint scored on the
    card and on the CPU. Returns K3's launches of the three commands."""
    wav, y = train_corpus(16, 147)
    audio = os.path.join(d, "corpus")
    paths = []
    for i, (row, label) in enumerate(zip(wav.cpu().numpy(), y.tolist())):
        paths.append(os.path.join(audio, "spoof" if label else "bonafide", f"u{i:02d}.wav"))
        os.makedirs(os.path.dirname(paths[-1]), exist_ok=True)
        write_wav(paths[-1], np.clip(row, -0.999, 0.999), SR)
    launches = 0
    one = paths[0]
    t0 = time.perf_counter()
    stdout, counts = run_counted(lambda: cli_main_quiet(
        ["xai", one, "--device", DEVICE, "--methods", "saliency,gradcam,ig,occlusion,lime", "--html",
         "--output-dir", os.path.join(d, "xai_out")]))
    launches += expect_launched(counts, "ct_mel", "xai CLI")
    lime = json.loads(stdout.strip().splitlines()[0])
    cpu_lime = json.loads(cli_main_quiet(["xai", one, "--device", "cpu", "--methods", "lime",
                                          "--output-dir", os.path.join(d, "xai_cpu")]).strip().splitlines()[0])
    lime_rel = abs(lime["lime_score"] - cpu_lime["lime_score"]) / abs(cpu_lime["lime_score"])
    log("models-cli", command="xai", wall_s=f"{time.perf_counter() - t0:.1f}", launches=counts["ct_mel"],
        outputs=",".join(sorted(os.listdir(os.path.join(d, "xai_out")))), lime_score=f"{lime['lime_score']:.6f}",
        lime_score_rel_diff_vs_cpu=f"{lime_rel:.3e}",
        top_components=",".join(map(str, lime["lime_top_components"])))
    if lime_rel > CLI_SCORE_RTOL or len(lime["lime_top_components"]) != 5:
        raise AssertionError(f"xai CLI: card {lime} vs CPU {cpu_lime}")
    feats, _ = model_features(wav)
    for command, model_cls, take in (("train-mfca", MobileNetMFCA, ("logmel",)),
                                     ("train-3features", MoreFeaturesClassifier, ("cqcc", "gfcc", "mfcc"))):
        run = os.path.join(d, command)
        t0 = time.perf_counter()
        stdout, counts = run_counted(lambda: cli_main_quiet(
            [command, audio, "--device", DEVICE, "--epochs", "2", "--batch-size", "4", "--run-dir", run]))
        launches += expect_launched(counts, "ct_mel", f"{command} CLI")
        metrics = json.loads(stdout.strip().splitlines()[-1])
        scores = []
        payload = load_payload(os.path.join(run, "best_model.msgpack"))
        for device in (DEVICE, "cpu"):
            model = model_cls()
            model.load_state_dict(flax_to_torch_resnet({"params": payload["params"], "batch_stats": payload["batch_stats"]}))
            with torch.no_grad():
                scores.append(model.to(device).eval()(*(feats[k].to(device) for k in take)).cpu())
        rel = float((scores[0] - scores[1]).abs().max() / scores[1].abs().max())
        log("models-cli", command=command, wall_s=f"{time.perf_counter() - t0:.1f}", launches=counts["ct_mel"],
            eer=f"{metrics['eer']:.4f}", accuracy=f"{metrics['accuracy']:.4f}", best_scores_rel_diff_vs_cpu=f"{rel:.3e}",
            run_files=",".join(sorted(os.listdir(run))))
        if rel > CLI_SCORE_RTOL or not np.isfinite(list(metrics.values())).all():
            raise AssertionError(f"{command} CLI: best checkpoint card vs CPU {rel:.3e}, metrics {metrics}")
    return launches


def phase_models_xai() -> dict:
    """Phase 14; returns K3's launches of its paths (the models' features
    and the three CLIs)."""
    wav, y = train_corpus(MODEL_BATCH, 148)
    feats, launches = model_features(wav)
    log("models", rows=MODEL_BATCH, ct_mel_launches=launches,
        **{k: tuple(f.shape[1:]) for k, f in feats.items()})
    out = {}
    for name, (make, inputs) in model_zoo().items():
        out[name] = model_card_vs_cpu(name, make, inputs(feats), y)
    out["xai"] = xai_card_vs_cpu(feats)
    out["compare"] = xai_compare_card_vs_cpu()
    del wav, feats
    free()
    with tempfile.TemporaryDirectory() as d:
        launches += models_cli(d)
    return {"ct_mel": launches, **out}


# Phase 15: the classical-ML path. Fold scale of classical_main at the
# reference's cap (LA 5000 files: 4,000 train rows, ~7,200 once balanced,
# cv=3), over 76 columns (the expanded widths of its six features).
CLASSICAL_ROWS, CLASSICAL_COLS, GRID_ROWS, CLASSICAL_TEST = 4800, 76, 7200, 1000
# Card against the port on the host's CPU. The bounds of the CPU tests
# against sklearn (tests/test_torch_ml.py): standardized values absolute;
# PCA transforms relative to their largest entry (float64 eigh or SVD on
# cuSOLVER against LAPACK); FastICA sources absolute, the same n_iter_;
# HGB probabilities absolute (float64 histogram sums taken in another
# order by the card's atomics), the same tree and leaf counts. SVC is held
# tighter than its test against libsvm (2e-3, libsvm's slack at tol 1e-3):
# both devices run the same SMO path, so they must take the same steps to
# the same support vectors, and their decision values (6.3e-13 apart at
# C=10 on an H100) must agree to rounding; a step taken differently moves
# them by up to the 1e-5 stop
SCALER_TOL, PCA_RTOL, ICA_TOL, SVC_TOL, HGB_TOL = 1e-12, 1e-9, 1e-6, 1e-8, 1e-6
# (b) times one candidate of each grid: the full grids take 78.9 + 45.5 s
# on an H100 (PERF.md), past the script's share; empty an arm's to run it
GRID_CANDIDATE = {"svm": dict(pca_components=(40,), svm_c=(1,)),
                  "xgb": dict(pca_components=(40,), n_estimators=(100,), max_depth=(3,))}
# SMO's two loops on the card (ml/svm.py: eager blocks, or blocks recorded
# as a CUDA graph) timed at the gridsearch CLI's fit size up to the fold's
SMO_PATH_ROWS = (16, 256, 4800)


def classical_data(n: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """(n, 76) float64 features and 0/1 labels: Laplace sources (so ICA has
    non-Gaussian structure to find) through a fixed mixing, the label a
    noisy nonlinear function of four sources."""
    mixing = np.random.default_rng(150).standard_normal((CLASSICAL_COLS, CLASSICAL_COLS)) / np.sqrt(CLASSICAL_COLS)
    rng = np.random.default_rng(seed)
    S = rng.laplace(size=(n, CLASSICAL_COLS))
    score = S[:, 0] + 0.7 * S[:, 1] - 0.5 * S[:, 2] * S[:, 3] + 0.8 * rng.standard_normal(n)
    return S @ mixing, (score > 0).astype(np.int64)


def timed_fit(fn):
    """(fn(), wall ms), synchronized on the card."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def classical_fits(device: str, rows: int = CLASSICAL_ROWS) -> dict:
    """(a)'s fits on ``device``: their outputs on held-out rows and ms per fit."""
    from audioanalysisdetector_tpu_torch import ml

    X, y = classical_data(rows, 151)
    Xq, _ = classical_data(CLASSICAL_TEST, 152)
    out = {}
    sc, out["scaler_ms"] = timed_fit(lambda: ml.StandardScaler(device=device).fit(X))
    Z, Zq = sc.transform(X), sc.transform(Xq)
    out["scaled"] = Z
    pca, out["pca_ms"] = timed_fit(lambda: ml.PCA(40, random_state=42, device=device).fit(Z))
    out["pca"] = (pca.components_.cpu().numpy(), pca.transform(Zq))
    ica, out["ica_ms"] = timed_fit(lambda: ml.FastICA(40, random_state=42, device=device).fit(Z))
    out["ica"] = (ica.transform(Zq), ica.n_iter_)
    P, Pq = pca.transform(Z), pca.transform(Zq)
    for C in (1.0, 10.0):
        svc, out[f"svc{C:g}_ms"] = timed_fit(lambda: ml.SVC(C=C, device=device).fit(P, y))
        out[f"svc{C:g}"] = (svc.decision_function(Pq), int(svc.n_iter_[0]), len(svc.support_))
    hgb, out["hgb_ms"] = timed_fit(lambda: ml.HistGradientBoostingClassifier(
        max_iter=100, max_depth=5, random_state=42, device=device).fit(Z, y))
    out["hgb"] = (hgb.predict_proba(Zq), hgb.n_iter_, int(sum(hgb.n_leaves_)))
    return out


def classical_estimators(card: dict, cpu: dict) -> None:
    """(a) Each estimator at the fold scale on the card against the CPU
    (``classical_fits`` on each)."""
    scaler_err = float(np.abs(card["scaled"] - cpu["scaled"]).max())
    comp_card, comp_cpu = card["pca"][0], cpu["pca"][0]
    signs = np.sign((comp_card * comp_cpu).sum(1, keepdims=True))
    pca_err = float(max(np.abs(comp_card * signs - comp_cpu).max(),
                        np.abs(card["pca"][1] - cpu["pca"][1]).max() / np.abs(cpu["pca"][1]).max()))
    ica_err = float(np.abs(card["ica"][0] - cpu["ica"][0]).max())
    log("classical", part="a", rows=CLASSICAL_ROWS, cols=CLASSICAL_COLS, scaler_ms=f"{card['scaler_ms']:.3f}",
        scaler_err=f"{scaler_err:.3e}", pca_ms=f"{card['pca_ms']:.3f}", pca_rel_err=f"{pca_err:.3e}",
        ica_ms=f"{card['ica_ms']:.3f}", ica_iters=f"{card['ica'][1]},{cpu['ica'][1]}", ica_err=f"{ica_err:.3e}",
        cpu_ms="scaler=%.1f,pca=%.1f,ica=%.1f" % (cpu["scaler_ms"], cpu["pca_ms"], cpu["ica_ms"]))
    bad = []
    if scaler_err > SCALER_TOL:
        bad.append(f"scaler {scaler_err:.3e}")
    if pca_err > PCA_RTOL:
        bad.append(f"PCA {pca_err:.3e}")
    if ica_err > ICA_TOL or card["ica"][1] != cpu["ica"][1]:
        bad.append(f"FastICA {ica_err:.3e}, n_iter {card['ica'][1]} vs {cpu['ica'][1]}")
    for C in ("1", "10"):
        (dec, steps, n_sv), (dec_cpu, steps_cpu, n_sv_cpu) = card[f"svc{C}"], cpu[f"svc{C}"]
        err = float(np.abs(dec - dec_cpu).max())
        log("classical", part="a", fit=f"svc_rbf_C{C}", rows=CLASSICAL_ROWS, cols=40,
            card_ms=f"{card[f'svc{C}_ms']:.1f}", cpu_ms=f"{cpu[f'svc{C}_ms']:.1f}", smo_steps=f"{steps},{steps_cpu}",
            ms_per_step=f"{card[f'svc{C}_ms'] / steps:.4f}", support=f"{n_sv},{n_sv_cpu}", decision_err=f"{err:.3e}")
        if err > SVC_TOL or steps != steps_cpu or n_sv != n_sv_cpu:
            bad.append(f"SVC C={C} {err:.3e}, SMO steps {steps}/{steps_cpu}, support {n_sv}/{n_sv_cpu}")
    (proba, trees, leaves), (proba_cpu, trees_cpu, leaves_cpu) = card["hgb"], cpu["hgb"]
    err = float(np.abs(proba - proba_cpu).max())
    log("classical", part="a", fit="hgb_100_depth5", rows=CLASSICAL_ROWS, cols=CLASSICAL_COLS,
        card_ms=f"{card['hgb_ms']:.1f}", cpu_ms=f"{cpu['hgb_ms']:.1f}", trees=f"{trees},{trees_cpu}",
        leaves=f"{leaves},{leaves_cpu}", ms_per_tree=f"{card['hgb_ms'] / trees:.3f}", proba_err=f"{err:.3e}")
    if err > HGB_TOL or trees != trees_cpu or leaves != leaves_cpu:
        bad.append(f"HGB {err:.3e}, trees {trees}/{trees_cpu}, leaves {leaves}/{leaves_cpu}")
    if bad:
        raise AssertionError("classical estimators, card vs CPU: " + "; ".join(bad))


def classical_grid_search(d: str) -> None:
    """(b) ``classical_main``'s two grids (``svm_grid``, ``xgb_grid``) at the
    reference's scale on the card, cv=3, each cut to ``GRID_CANDIDATE``
    (PCA 40 with C 1; PCA 40, 100 iterations, depth 3): its three folds
    and the refit."""
    from audioanalysisdetector_tpu_torch import ml
    from audioanalysisdetector_tpu_torch.train.classical import svm_grid, xgb_grid

    X, y = classical_data(GRID_ROWS + CLASSICAL_TEST, 153)
    scaler = ml.StandardScaler(device=DEVICE).fit(X[:GRID_ROWS])
    Xtr, Xte = scaler.transform(X[:GRID_ROWS]), scaler.transform(X[GRID_ROWS:])
    ytr, yte = y[:GRID_ROWS], y[GRID_ROWS:]
    cache_dir = os.path.join(d, "grid_cache")
    for arm, search in (("svm", svm_grid), ("xgb", xgb_grid)):
        res, ms = timed_fit(lambda: search(Xtr, ytr, Xte, yte, cache_dir=cache_dir, device=DEVICE,
                                           **GRID_CANDIDATE[arm]))
        log("classical", part="b", arm=arm, rows=GRID_ROWS, cols=CLASSICAL_COLS, cv=3,
            grid="one candidate" if GRID_CANDIDATE[arm] else "full", grid_s=f"{ms / 1e3:.1f}",
            accuracy=f"{res['accuracy']:.4f}", f1=f"{res['f1']:.4f}",
            best_params=",".join(f"{k}={v}" for k, v in res["best_params"].items()))
        if not 0.5 < res["accuracy"] <= 1.0:
            raise AssertionError(f"classical grid {arm}: accuracy {res['accuracy']}")


def smo_fit_ms(n: int, graph: bool) -> tuple[float, int]:
    """(ms, steps) of one SMO solve on the card (rbf, C 1, gamma "scale",
    the Gram matrix built outside the timing) over ``n`` standardized rows
    of ``classical_data``, through ``ml/svm.py``'s eager loop or its CUDA
    graph."""
    from audioanalysisdetector_tpu_torch.ml import svm

    X, y = classical_data(n, 156)
    X = torch.as_tensor((X - X.mean(0)) / X.std(0), device=DEVICE)
    K = svm.kernel_matrix(X, X, "rbf", 1.0 / (X.shape[1] * float(X.var(correction=0))))
    sign = torch.as_tensor(2.0 * y - 1.0, dtype=torch.float64, device=DEVICE)
    smo = svm._SMO(K, sign, 1.0, svm.SMO_TOL)
    steps, ms = timed_fit(lambda: smo.solve(10_000_000, graph=graph))
    return ms, steps


def smo_paths() -> float:
    """(a) SMO's eager loop against its CUDA graph on the card, per fit,
    from the gridsearch CLI's 16 rows to the fold's 4,800 (median of a few
    fits where they are short); returns the graph's ms at the last size."""
    smo_fit_ms(16, True), smo_fit_ms(16, False)  # warm-up
    for n in SMO_PATH_ROWS:
        reps = 9 if n <= 256 else 1
        ms = {}
        for graph in (False, True):
            runs = [smo_fit_ms(n, graph) for _ in range(reps)]
            ms[graph], steps = float(np.median([r[0] for r in runs])), runs[0][1]
        log("classical", part="a", smo_path_rows=n, smo_steps=steps, eager_ms=f"{ms[False]:.3f}",
            graph_ms=f"{ms[True]:.3f}", graph_over_eager=f"{ms[True] / ms[False]:.3f}")
    return ms[True]


def classical_corpus(d: str) -> tuple[str, str, str]:
    """(c)'s inputs: a small surrogate corpus (metadata, FLAC dir) and 16 WAVs
    in bonafide/ and spoof/ directories."""
    from audioanalysisdetector_tpu_torch.data.synthetic import make_surrogate_corpus

    meta, flac = make_surrogate_corpus(os.path.join(d, "corpus"), n_bonafide=16, n_spoof_per_tier=4,
                                       seconds=1.5, seed=5, subset="train")
    wavs = os.path.join(d, "wavs")
    for i, (row, label) in enumerate(zip(*train_corpus(16, 154))):
        path = os.path.join(wavs, "spoof" if label else "bonafide", f"u{i:02d}.wav")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        write_wav(path, np.clip(row.cpu().numpy(), -0.999, 0.999), SR)
    return meta, flac, wavs


def classical_cli_runs(d: str, meta: str, flac: str, wavs: str, device: str) -> dict:
    """(c)'s two commands on ``device``: {command: (result, wall s, K3
    launches)}, each command's launches counted from 0 (0 on the CPU)."""
    counted = run_counted if device != "cpu" else (lambda fn: (fn(), launch_counts()))
    gs_dir = os.path.join(d, f"gs_{device}")
    argvs = {
        "classical": ["classical", "--dataset", f"LA:{meta}:{flac}", "--seconds", "1.5", "--components", "4,8",
                      "--cache-dir", os.path.join(d, f"cache_{device}"), "--device", device],
        "gridsearch": ["gridsearch", wavs, "--features", "mfcc", "--components", "4", "--output-dir", gs_dir,
                       "--cache-dir", os.path.join(d, f"gs_cache_{device}"), "--device", device],
    }
    out = {}
    for command, argv in argvs.items():
        t0 = time.perf_counter()
        reset_launch_counts()
        stdout, counts = counted(lambda: cli_main_quiet(argv))
        if command == "classical":
            result = json.loads(stdout.strip().splitlines()[-1])
        else:
            with open(os.path.join(gs_dir, "gridsearch_summary.csv")) as f:
                result = f.read()
        out[command] = (result, time.perf_counter() - t0, counts["ct_mel"])
    return out


def classical_clis(card: dict, cpu: dict) -> int:
    """(c) The ``classical`` and ``gridsearch`` CLIs on the card against
    ``--device cpu`` (``classical_cli_runs`` on each); returns K3's
    launches of the card runs."""
    launches = 0
    for command in ("classical", "gridsearch"):
        (got, wall, n_k3), (want, cpu_wall, _) = card[command], cpu[command]
        launches += expect_launched({"ct_mel": n_k3}, "ct_mel", f"{command} CLI")
        if command == "classical":
            same = all(got[a][k] == want[a][k] for a in ("svm", "xgb") for k in ("accuracy", "best_params"))
            shown = {a: (got[a]["accuracy"], got[a]["best_params"]) for a in ("svm", "xgb")}
        else:
            same = got == want
            shown = f"{got.count(chr(10)) - 1} rows"
        log("classical", part="c", command=command, wall_s=f"{wall:.1f}", cpu_wall_s=f"{cpu_wall:.1f}",
            ct_mel_launches=n_k3, equal_to_cpu=same, result=json.dumps(shown))
        if not same:
            raise AssertionError(f"{command} CLI: card {got} vs CPU {want}")
    return launches


def _unpadded_trace(trace_dir: str) -> None:
    """A ``device_trace`` of one warm ``ct_mel_unpadded`` call at B=8192.
    It runs in a process of its own: in this one, once the SMO's CUDA
    graphs have run, later traces lose kernel records (PERF.md §7)."""
    from audioanalysisdetector_tpu_torch.utils import device_trace

    cfg = MelConfig.for_profile("parity", SR)
    wav = waves(BATCH, 155)
    ctm.ct_mel_unpadded(wav, cfg)
    with device_trace(trace_dir):
        ctm.ct_mel_unpadded(wav, cfg)


def classical_profiling(d: str) -> None:
    """(d) ``StepTimer`` around one K3 call; ``device_trace`` of
    ``ct_mel_unpadded``, whose file holds K3 and no reflect-pad kernel (the
    pad is folded into K3's frame addressing)."""
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor

    from audioanalysisdetector_tpu_torch.utils import StepTimer

    cfg = MelConfig.for_profile("parity", SR)
    padded = center_pad(waves(BATCH, 155), cfg.n_fft, cfg.pad_mode).contiguous()
    T = n_frames_for(N_SAMPLES, cfg.hop_length, cfg.n_fft, cfg.center)
    k3 = lambda: ctm.ct_mel(padded, cfg, n_frames=T)  # noqa: E731
    timer = StepTimer("ct_mel")
    for _ in range(6):
        with timer.measure() as sync:
            sync(k3())
    steps = timer.summary(items_per_step=BATCH)
    trace_dir = os.path.join(d, "trace")
    with ProcessPoolExecutor(1, mp_context=mp.get_context("spawn")) as pool:
        pool.submit(_unpadded_trace, trace_dir).result()
    traces = os.listdir(trace_dir)
    names = set()
    for t in traces:
        with open(os.path.join(trace_dir, t)) as f:
            names.update(e.get("name", "") for e in json.load(f)["traceEvents"])
    pads = sorted(n for n in names if "reflection_pad" in n)
    log("classical", part="d", step_timer_mean_ms=f"{steps['mean_ms']:.3f}", step_timer_p99_ms=f"{steps['p99_ms']:.3f}",
        trace_files=",".join(traces), trace_bytes=sum(os.path.getsize(os.path.join(trace_dir, t)) for t in traces),
        pad_kernels=",".join(pads) or "none", k3_in_trace=any("ct_mel_kernel" in n for n in names))
    if not traces or not 0 < steps["mean_ms"] < 1e3 or pads or not any("ct_mel_kernel" in n for n in names):
        raise AssertionError(f"profiling: {steps}, traces {traces}")


def _cpu_helper_init() -> None:
    torch.set_num_threads(3)  # two helpers; the card process keeps the other cores


def phase_classical() -> dict:
    """Phase 15; returns K3's launches of the two CLIs on the card (their
    MFCC at 128 mels). The card's fits of (a) are timed with the host to
    themselves; then the CPU references of (a) and (c) run in two spawned
    helper processes (no CUDA there) while the card runs (b) to (d), whose
    walls are thus taken beside them (one SMO solve of (a) is timed again
    there to show what they cost); the comparisons come last."""
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor

    with tempfile.TemporaryDirectory() as d:
        classical_fits(DEVICE, rows=256)  # warm-up: the card's libraries load on first use
        card_fits = classical_fits(DEVICE)
        alone_ms = smo_paths()
        free()
        corpus = classical_corpus(d)
        with ProcessPoolExecutor(2, mp_context=mp.get_context("spawn"), initializer=_cpu_helper_init) as pool:
            cpu_fits = pool.submit(classical_fits, "cpu")
            cpu_clis = pool.submit(classical_cli_runs, d, *corpus, "cpu")
            beside_ms, _ = smo_fit_ms(SMO_PATH_ROWS[-1], True)
            log("classical", part="a", smo_rows=SMO_PATH_ROWS[-1], graph_ms_alone=f"{alone_ms:.3f}",
                graph_ms_beside_cpu_helpers=f"{beside_ms:.3f}")
            free()
            classical_grid_search(d)
            free()
            card_clis = classical_cli_runs(d, *corpus, DEVICE)
            classical_profiling(d)
            classical_estimators(card_fits, cpu_fits.result())
            launches = classical_clis(card_clis, cpu_clis.result())
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
    smi = phase_device()
    timed_phase(phase_build)
    k1 = timed_phase(phase_k1)
    k3 = timed_phase(phase_k3)
    k2 = timed_phase(phase_k2)
    k4_timed = timed_phase(phase_k4)
    k5_timed = timed_phase(phase_k5)
    k6_timed = timed_phase(phase_k6)
    launches = {"wave_mel": 0, "ct_mel": 0, "fused_mel_from_frames": k2["launches"], "lstm_scan": 0,
                "lstm_scan.h32": 0, "cqcc": 0, "gmm_llr": 0}
    for part in (timed_phase(phase_e2e)[0], timed_phase(phase_serve), timed_phase(phase_score)):
        for name, n in part.items():
            launches[name] += n
    fused = timed_phase(phase_fused)
    launches["lstm_scan"] += fused["lstm_scan"]
    launches["cqcc"] += fused["cqcc"]
    launches["gmm_llr"] += fused["gmm_llr"]
    launches["wave_mel"] += timed_phase(phase_whisper)["wave_mel"]
    launches["wave_mel"] += timed_phase(phase_voxtral)["wave_mel"]
    launches["ct_mel"] += timed_phase(phase_train)["ct_mel"]
    timed_phase(phase_gmm_train)
    launches["ct_mel"] += timed_phase(phase_features)["ct_mel"]
    launches["ct_mel"] += timed_phase(phase_multi)["ct_mel"]
    launches["ct_mel"] += timed_phase(phase_models_xai)["ct_mel"]
    launches["ct_mel"] += timed_phase(phase_classical)["ct_mel"]
    timed = {
        "wave_mel": k1["parity"],
        "fused_mel_from_frames": k2[("parity", "float32")],
        "ct_mel": k3,
        "lstm_scan": k4_timed["lstm_scan"],
        "lstm_scan.h32": k4_timed["lstm_scan.h32"],
        "cqcc": k5_timed,
        "gmm_llr": k6_timed,
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
    print(smi, flush=True)  # again, so the card and its power limit stand beside the results
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
