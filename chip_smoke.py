#!/usr/bin/env python3
"""Card check of the PyTorch port: build, kernel vs plain, e2e, serving.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

It drives ``audioanalysisdetector_tpu_torch``'s main path (wav -> log-mel
through the hand-written ``wave_mel`` kernel -> CNN-BiLSTM -> score) at the
flagship model's full width, in six phases, each printing one line:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA;
2. build: compiles the kernel from ``ops/csrc`` with nvcc;
3. kernel vs plain: ``wave_mel`` against ``wave_mel_reference`` on the card
   in both mel profiles (random input at B=8192, a ragged batch of 13,
   silence), mel power and dB, and both times from CUDA events;
4. e2e: the scorer at B=8192 x 2 s in both profiles, against the same model
   fed the plain mel path, plus a float64 numpy check of the features;
5. serving: 8 concurrent HTTP requests through BatchingScorer/ScoreServer;
6. the result: a JSON line of the kernels, then ``{"ok": true, ...}`` last.

Every failure raises and exits nonzero; without a CUDA card it exits 1
before printing any result. Weights are random, from a numpy seed.
"""

from __future__ import annotations

import base64
import json
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import torch

from audioanalysisdetector_tpu_torch.convert import (
    flax_to_torch_cnn_bilstm,
    random_flax_cnn_bilstm,
)
from audioanalysisdetector_tpu_torch.frontend.db import power_to_db
from audioanalysisdetector_tpu_torch.frontend.mel import (
    MelConfig,
    log_mel_spectrogram,
    melspectrogram,
)
from audioanalysisdetector_tpu_torch.frontend.stft import (
    _window_array,
    center_pad,
    n_frames_for,
)
from audioanalysisdetector_tpu_torch.models.cnn_bilstm import CNNBiLSTMHybrid
from audioanalysisdetector_tpu_torch.ops import _build
from audioanalysisdetector_tpu_torch.ops import wave_mel as wm  # the module: counter
from audioanalysisdetector_tpu_torch.score.e2e import make_mel_cnn_bilstm_scorer
from audioanalysisdetector_tpu_torch.serve.server import (
    BatchingScorer,
    ScoreServer,
    build_mel_scorer,
    default_bucket_ladder,
)

SR, N_SAMPLES, BATCH = 16000, 32000, 8192
PROFILES = ("parity", "speech")
# Mel power, kernel vs plain, relative to each utterance's max power: both
# are fp32 sums of n_fft products (up to 2048) and of the mel contraction,
# taken in different orders, so they differ by rounding of order
# sqrt(n_fft) * 2^-24 of the largest terms; 1e-4 leaves two decades.
REL_TOL = 1e-4
# log-mel, kernel vs plain, in dB: a relative power error e moves dB by
# 4.3 e, and top_db=80 keeps values within 80 dB of the per-utterance max.
DB_TOL = 1e-3
# scores, scorer (kernel) vs the same model fed the plain mel path
SCORE_TOL = 1e-4
# serving vs the direct scorer on the same rows: other batch sizes may pick
# other cuDNN / cuBLAS algorithms for the model, so rounding differs
SERVE_TOL = 1e-5


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


def waves(batch: int, seed: int) -> torch.Tensor:
    g = torch.Generator(device="cuda").manual_seed(seed)
    return 0.1 * torch.randn((batch, N_SAMPLES), generator=g, device="cuda")


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    """max |got - ref| relative to each utterance's max |ref| (0 for silence)."""
    peak = ref.abs().amax(dim=(1, 2), keepdim=True).clamp_min(1e-30)
    return float(((got - ref).abs() / peak).max())


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


def phase_build() -> None:
    t0 = time.perf_counter()
    _build.load_library("wave_mel")
    info = _build.build_log["wave_mel"]
    log("build", kernel="wave_mel", nvcc_s=f"{info['seconds']:.2f}",
        load_s=f"{time.perf_counter() - t0:.2f}")
    for line in info["output"].splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas: " + line.strip(), flush=True)


def phase_kernel() -> dict:
    """Kernel vs plain in both profiles; returns the numbers per profile."""
    results = {}
    for profile in PROFILES:
        cfg = MelConfig.for_profile(profile, SR)
        T = n_frames_for(N_SAMPLES, cfg.hop_length, cfg.n_fft, cfg.center)
        max_abs, max_rel, max_db = 0.0, 0.0, 0.0
        for case, batch in (("random", BATCH), ("ragged", 13), ("silence", 64)):
            wav = waves(batch, 1) if case != "silence" else torch.zeros((batch, N_SAMPLES), device="cuda")
            padded = center_pad(wav, cfg.n_fft, cfg.pad_mode).contiguous()
            got = wm.wave_mel(padded, cfg, n_frames=T)
            ref = wm.wave_mel_reference(padded, cfg, n_frames=T)
            torch.cuda.synchronize()
            if got.shape != (batch, T, cfg.n_mels) or not torch.isfinite(got).all():
                raise AssertionError(f"{profile}/{case}: bad kernel output {tuple(got.shape)}")
            rel = rel_err(got, ref)
            db_got = log_mel_spectrogram(wav, cfg)  # CUDA route: the kernel
            db_ref = power_to_db(ref.transpose(1, 2), ref="max", top_db=80.0)
            db = float((db_got - db_ref).abs().max())
            max_abs = max(max_abs, float((got - ref).abs().max()))
            max_rel, max_db = max(max_rel, rel), max(max_db, db)
            log("kernel", profile=profile, case=case, batch=batch,
                rel_err=f"{rel:.3e}", db_err=f"{db:.3e}")
            if rel > REL_TOL or db > DB_TOL:
                raise AssertionError(
                    f"{profile}/{case}: kernel disagrees with plain (rel {rel:.3e} > "
                    f"{REL_TOL} or dB {db:.3e} > {DB_TOL})"
                )
        wav = waves(BATCH, 2)
        padded = center_pad(wav, cfg.n_fft, cfg.pad_mode).contiguous()
        kern = lambda: wm.wave_mel(padded, cfg, n_frames=T)  # noqa: E731
        plain = lambda: wm.wave_mel_reference(padded, cfg, n_frames=T)  # noqa: E731
        kern(), plain()
        torch.cuda.synchronize()
        # in turns, plain-kernel-kernel-plain, so drift hits both alike
        p1, k1, k2, p2 = (cuda_ms(f, 5) for f in (plain, kern, kern, plain))
        ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
        flop = 4.0 * BATCH * T * cfg.n_fft * (cfg.n_fft // 2 + 1)
        log("kernel", profile=profile, batch=BATCH, kernel_ms=f"{ms:.3f}",
            plain_ms=f"{plain_ms:.3f}", kernel_runs=f"{k1:.3f},{k2:.3f}",
            plain_runs=f"{p1:.3f},{p2:.3f}", dft_tflop=f"{flop / 1e12:.3f}",
            kernel_dft_tflops=f"{flop / ms / 1e9:.2f}")
        results[profile] = {"ms": ms, "plain_ms": plain_ms, "max_abs_err": max_abs}
    return results


def numpy_mel64(wav: np.ndarray, cfg: MelConfig) -> np.ndarray:
    """Independent float64 mel power: numpy rfft of reflect-padded frames."""
    pad = cfg.n_fft // 2
    y = np.pad(wav.astype(np.float64), ((0, 0), (pad, pad)), mode="reflect")
    T = 1 + (y.shape[1] - cfg.n_fft) // cfg.hop_length
    idx = np.arange(T)[:, None] * cfg.hop_length + np.arange(cfg.n_fft)[None, :]
    spec = np.fft.rfft(y[:, idx] * _window_array(cfg.window, cfg.n_fft, cfg.n_fft), axis=-1)
    return np.einsum("mf,btf->bmt", cfg.filterbank(), np.abs(spec) ** 2)


def phase_e2e() -> tuple[int, dict]:
    """The scorer in both profiles; returns (kernel launches, utt/s)."""
    launches, rates = 0, {}
    for profile in PROFILES:
        cfg = MelConfig.for_profile(profile, SR)
        T = n_frames_for(N_SAMPLES, cfg.hop_length, cfg.n_fft, cfg.center)
        model = CNNBiLSTMHybrid(T)
        model.load_state_dict(flax_to_torch_cnn_bilstm(random_flax_cnn_bilstm(0, T)))
        model = model.to("cuda").eval()
        score = make_mel_cnn_bilstm_scorer(model, cfg)

        small = np.random.default_rng(3).standard_normal((4, N_SAMPLES)).astype(np.float32) * 0.1
        feats = melspectrogram(torch.from_numpy(small).cuda(), cfg).double().cpu().numpy()
        ref64 = numpy_mel64(small, cfg)
        small_rel = float((np.abs(feats - ref64) / ref64.max(axis=(1, 2), keepdims=True)).max())
        if small_rel > REL_TOL:
            raise AssertionError(f"{profile}: mel vs float64 numpy rel err {small_rel:.3e}")

        wav = waves(BATCH, 4)
        wm.launches = 0
        scores = score(wav)
        torch.cuda.synchronize()
        run_launches = wm.launches
        launches += run_launches
        if run_launches < 1:
            raise AssertionError(f"{profile}: the scorer did not launch the wave_mel kernel")
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
        log("e2e", profile=profile, batch=BATCH, launches=run_launches,
            score_diff_vs_plain=f"{diff:.3e}", mel_vs_numpy64=f"{small_rel:.3e}",
            score_range=f"{float(scores.min()):.4f}..{float(scores.max()):.4f}",
            ms=f"{ms:.3f}", utt_per_s=f"{rates[profile]:.1f}")
    return launches, rates


def _post(url: str, body: bytes, headers: dict) -> tuple[int, dict]:
    req = urllib.request.Request(url, data=body, headers=headers, method="POST")
    with urllib.request.urlopen(req, timeout=120) as resp:
        return resp.status, json.loads(resp.read())


def phase_serve() -> int:
    """8 concurrent requests through the HTTP service; returns launches."""
    scorer, n_samples = build_mel_scorer(sr=SR, seconds=N_SAMPLES / SR, device="cuda", seed=0)
    batcher = BatchingScorer(
        scorer, n_samples=n_samples, max_batch=256, bucket_sizes=default_bucket_ladder(256)
    )
    batcher.warm_up()
    server = ScoreServer(batcher, sr=SR, host="127.0.0.1", port=0)
    server.start_background()
    try:
        base = f"http://127.0.0.1:{server.port}"
        rng = np.random.default_rng(5)
        rows = [(rng.standard_normal((1 + 2 * i, n_samples)) * 0.1).astype(np.float32) for i in range(8)]
        results: list = [None] * 8

        def send(i: int) -> None:
            data = rows[i].astype("<f4").tobytes()
            if i % 2 == 0:
                body = json.dumps({"pcm_b64": base64.b64encode(data).decode(), "rows": len(rows[i])})
                results[i] = _post(f"{base}/v1/score", body.encode(), {"Content-Type": "application/json"})
            else:
                results[i] = _post(f"{base}/v1/score_raw", data, {
                    "Content-Type": "application/octet-stream", "X-Rows": str(len(rows[i]))})

        wm.launches = 0
        threads = [threading.Thread(target=send, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        launches = wm.launches
        if any(t.is_alive() for t in threads) or any(r is None for r in results):
            raise AssertionError("a serving request did not complete")
        worst = 0.0
        for i, (status, payload) in enumerate(results):
            if status != 200:
                raise AssertionError(f"request {i}: HTTP {status}")
            worst = max(worst, float(np.abs(np.asarray(payload["scores"]) - scorer(rows[i])).max()))
        if worst > SERVE_TOL:
            raise AssertionError(f"served scores differ from the direct scorer by {worst:.3e}")
        with urllib.request.urlopen(f"{base}/healthz", timeout=30) as resp:
            health = json.loads(resp.read())
        if health["platform"] != "cuda":
            raise AssertionError(f"/healthz says {health['platform']!r}, not 'cuda'")
        if launches < 1:
            raise AssertionError("serving did not launch the wave_mel kernel")
        log("serve", requests=8, rows=sum(len(r) for r in rows), launches=launches,
            max_diff_vs_direct=f"{worst:.3e}", healthz=health["platform"],
            stats=json.dumps(batcher.stats.snapshot(), separators=(",", ":")))
    finally:
        server.close()
    return launches


def main() -> int:
    t0 = time.perf_counter()
    phase_device()
    phase_build()
    kern = phase_kernel()
    launches, _ = phase_e2e()
    launches += phase_serve()
    print(json.dumps({"kernels": [{
        "name": "wave_mel",
        "route": "cuda",
        "source": "audioanalysisdetector_tpu_torch/ops/csrc/wave_mel.cu",
        "replaces": "audioanalysisdetector_tpu/ops/wave_mel.py:63",
        "launches": launches,
        "max_abs_err": kern["parity"]["max_abs_err"],
        "ms": kern["parity"]["ms"],
        "plain_ms": kern["parity"]["plain_ms"],
    }]}), flush=True)
    log("done", seconds=f"{time.perf_counter() - t0:.1f}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
