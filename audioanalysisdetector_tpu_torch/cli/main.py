"""Command-line entry points of the PyTorch port.

  score   log-mel + CNN-BiLSTM spoof scoring over a directory of WAV/FLAC files
  serve   HTTP scoring service: dynamic micro-batching in front of one card
  train   CNN-BiLSTM training run on log-mel features (one device)

The flags are those of the JAX package's commands, plus ``--device``.
Multi-device data parallelism (``serve --data-parallel on``) and
multi-process serving (``--workers`` > 1) are not ported yet and are
refused. Run as ``python -m audioanalysisdetector_tpu_torch score ...``.
"""

from __future__ import annotations

import argparse
import glob as globlib
import json
import os
import sys

import numpy as np


def _collect_wavs(path: str) -> list[str]:
    """All WAV/FLAC files under a directory, or a glob's matches."""
    if os.path.isdir(path):
        return sorted(
            globlib.glob(os.path.join(path, "**", "*.wav"), recursive=True)
            + globlib.glob(os.path.join(path, "**", "*.flac"), recursive=True)
        )
    return sorted(globlib.glob(path))


def _shuffle(paths: list[str], seed: int) -> list[str]:
    """Deterministic shuffle before head/tail splits — sorted collection
    groups labels by directory, which would otherwise yield one-class splits."""
    idx = np.random.default_rng(seed).permutation(len(paths))
    return [paths[i] for i in idx]


def _labels_from_dirnames(paths: list[str]) -> np.ndarray:
    """label = 1 iff any parent directory is named 'spoof'/'fake'."""
    return np.asarray(
        [1 if any(seg in ("spoof", "fake") for seg in p.split(os.sep)) else 0 for p in paths],
        dtype=np.int64,
    )


def _load_batch(paths: list[str], seconds: float, sr: int) -> tuple[list[str], np.ndarray]:
    """Decode fixed-length clips with the threaded native decoder; unreadable
    files are dropped with a warning. Returns (kept_paths, (B, n) float32)."""
    from audioanalysisdetector_tpu_torch.io.native_loader import load_chunk_batch_native

    out, ok = load_chunk_batch_native(
        paths, [0.0] * len(paths), [float(seconds)] * len(paths), sr=sr, return_ok=True
    )
    for p, good in zip(paths, ok):
        if not good:
            print(f"WARNING: cannot read {p}: skipped", file=sys.stderr)
    return [p for p, good in zip(paths, ok) if good], out[ok]


def cmd_train(args) -> int:
    """The JAX package's ``cli train`` on ``--device``: decode, log-mel once
    (the mel kernel on the card, under ``torch.no_grad()``), the seeded
    80/20 split, ``CNNBiLSTMHybrid(logits=True)`` from the flax-like init,
    ``fit`` with BCE, ``evaluate`` on the best state, one JSON line of
    metrics on stdout, the run's kernel launch counts on stderr."""
    import torch

    from audioanalysisdetector_tpu_torch.frontend.mel import MelConfig, log_mel_spectrogram
    from audioanalysisdetector_tpu_torch.models.cnn_bilstm import CNNBiLSTMHybrid
    from audioanalysisdetector_tpu_torch.models.layers import flax_init_
    from audioanalysisdetector_tpu_torch.ops import launch_counts
    from audioanalysisdetector_tpu_torch.train import TrainState, evaluate, fit, make_optimizer

    paths = _collect_wavs(args.audio)
    if len(paths) < 4:
        print("need at least 4 WAVs (with 'spoof'/'fake' dirs for labels)", file=sys.stderr)
        return 1
    paths, wav = _load_batch(_shuffle(paths, args.seed), args.seconds, args.sr)
    if len(paths) < 4:
        print(f"only {len(paths)} files decoded successfully — need at least 4", file=sys.stderr)
        return 1
    y = torch.from_numpy(_labels_from_dirnames(paths)).to(args.device)
    mel_cfg = MelConfig.for_profile(args.mel_profile, args.sr, n_mels=args.n_mels)
    with torch.no_grad():
        feats = log_mel_spectrogram(torch.from_numpy(wav).to(args.device), mel_cfg)
    split = max(int(len(paths) * 0.8), 1)
    model = CNNBiLSTMHybrid(feats.shape[-1], logits=True)
    flax_init_(model, torch.Generator().manual_seed(args.seed))
    state = TrainState.create(model=model.to(args.device), tx=make_optimizer(args.optimizer, args.lr))
    result = fit(
        state, (feats[:split], y[:split]), (feats[split:], y[split:]),
        loss_name="BCELoss", num_epochs=args.epochs, batch_size=args.batch_size,
        seed=args.seed, run_dir=args.run_dir, binary_head=True, verbose=True,
    )
    metrics = evaluate(
        result.best_state, (feats[split:], y[split:]), loss_name="BCELoss", binary_head=True
    )
    print(json.dumps(metrics))
    print(json.dumps({"kernel_launches": launch_counts()}), file=sys.stderr)
    return 0


def cmd_score(args) -> int:
    """Stream-decode the files and score them on ``--device``: one JSON
    line per file on stdout, then the kernel launch counts of the run as one
    JSON line on stderr."""
    from audioanalysisdetector_tpu_torch.frontend.mel import MelConfig
    from audioanalysisdetector_tpu_torch.ops import launch_counts
    from audioanalysisdetector_tpu_torch.score.e2e import (
        init_mel_cnn_bilstm,
        make_mel_cnn_bilstm_scorer,
    )
    from audioanalysisdetector_tpu_torch.score.streaming import score_paths

    if not args.checkpoint and not args.allow_random:
        print(
            "score: no --checkpoint given — scores from randomly initialized "
            "weights are meaningless. Pass --checkpoint <best_model.msgpack> "
            "(a JAX-saved payload) or <state_dict.pt> (torch.save), "
            "or --allow-random to proceed anyway (smoke tests only).",
            file=sys.stderr,
        )
        return 2
    paths = _collect_wavs(args.audio)
    if not paths:
        print(f"no WAV files under {args.audio}", file=sys.stderr)
        return 1
    mel_cfg = MelConfig.for_profile(args.mel_profile, args.sr, n_mels=args.n_mels)
    model = init_mel_cnn_bilstm(
        mel_cfg, int(args.seconds * args.sr), checkpoint=args.checkpoint,
        device=args.device,
    )
    kept, scores = score_paths(
        make_mel_cnn_bilstm_scorer(model, mel_cfg), paths, device=args.device,
        seconds=args.seconds, sr=args.sr, batch_size=args.batch_size,
    )
    for p, s in zip(kept, scores):
        print(json.dumps({"file": p, "spoof_score": float(s), "label": int(s > 0.5)}))
    print(json.dumps({"kernel_launches": launch_counts()}), file=sys.stderr)
    return 0


def cmd_serve(args) -> int:
    """HTTP scoring service (serve/server.py): build the scorer, warm up
    every bucket, bind, serve until SIGINT."""
    from audioanalysisdetector_tpu_torch.serve.server import (
        BatchingScorer,
        ScoreServer,
        build_mel_scorer,
        default_bucket_ladder,
    )

    if not args.checkpoint and not args.allow_random:
        print(
            "serve: no --checkpoint given — scores from randomly initialized "
            "weights are meaningless. Pass --checkpoint <best_model.msgpack> "
            "(a JAX-saved payload) or <state_dict.pt> (torch.save), "
            "or --allow-random to proceed anyway (smoke tests only).",
            file=sys.stderr,
        )
        return 2
    if args.workers > 1 or args.data_parallel == "on":
        print(
            "serve: --workers > 1 and --data-parallel on are not ported to "
            "audioanalysisdetector_tpu_torch yet (one device, one process)",
            file=sys.stderr,
        )
        return 2
    scorer, n_samples = build_mel_scorer(
        checkpoint=args.checkpoint,
        sr=args.sr,
        seconds=args.seconds,
        n_mels=args.n_mels,
        mel_profile=args.mel_profile,
        device=args.device,
    )
    if args.buckets:
        buckets = tuple(int(b) for b in args.buckets.split(","))
    else:
        buckets = default_bucket_ladder(args.max_batch)
    batcher = BatchingScorer(
        scorer,
        n_samples=n_samples,
        max_batch=args.max_batch,
        max_wait_ms=args.max_wait_ms,
        bucket_sizes=buckets,
        adaptive=not args.no_adaptive,
    )
    batcher.warm_up()
    server = ScoreServer(batcher, sr=args.sr, host=args.host, port=args.port)
    print(
        json.dumps(
            {
                "listening": f"http://{args.host}:{server.port}",
                "endpoints": ["/v1/score", "/v1/score_raw", "/v1/stats", "/healthz"],
                "max_batch": args.max_batch,
                "buckets": list(batcher.bucket_sizes),
                "n_samples": n_samples,
                "adaptive": batcher.adaptive,
                "device": args.device,
            }
        ),
        flush=True,
    )
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.close()
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="audioanalysisdetector_tpu_torch",
        description="audio deepfake detection on PyTorch + CUDA",
    )
    sub = p.add_subparsers(dest="command", required=True)

    def mel_flags(sp):
        sp.add_argument("--sr", type=int, default=16000)
        sp.add_argument("--seconds", type=float, default=2.0)
        sp.add_argument("--n-mels", type=int, default=64)
        sp.add_argument(
            "--mel-profile", choices=("parity", "speech"), default="parity",
            help="'parity' = librosa-default 2048-pt mel (the reference "
            "contract); 'speech' = 32 ms/16 ms speech-standard resolution "
            "(use the SAME profile for train + score)",
        )
        sp.add_argument(
            "--device", default="cuda",
            help="torch device the scorer runs on (cuda launches the mel "
            "kernel: ct_mel at parity, wave_mel at speech)",
        )

    sp = sub.add_parser("score", help="log-mel + CNN-BiLSTM spoof scoring")
    sp.add_argument("audio", help="WAV/FLAC directory or glob")
    mel_flags(sp)
    sp.add_argument(
        "--batch-size", type=int, default=512,
        help="streaming batch size (decode of batch k+1 overlaps device "
        "scoring of batch k)",
    )
    sp.add_argument(
        "--checkpoint", default=None,
        help="a JAX-saved .msgpack payload or a torch.save state dict",
    )
    sp.add_argument(
        "--allow-random", action="store_true",
        help="score with randomly initialized weights (smoke tests only)",
    )
    sp.set_defaults(fn=cmd_score)

    sp = sub.add_parser("train", help="CNN-BiLSTM training run")
    sp.add_argument("audio", help="WAV/FLAC directory or glob ('spoof'/'fake' dirs are label 1)")
    mel_flags(sp)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--epochs", type=int, default=5)
    sp.add_argument("--batch-size", type=int, default=16)
    sp.add_argument("--lr", type=float, default=1e-4)
    sp.add_argument("--optimizer", default="Adam", help="Adam, AdamW, SGD or RMSprop")
    sp.add_argument("--run-dir", default="runs/cnn_bilstm")
    sp.set_defaults(fn=cmd_train)

    sp = sub.add_parser(
        "serve", help="HTTP scoring service with dynamic micro-batching"
    )
    sp.add_argument("--host", default="127.0.0.1")
    sp.add_argument("--port", type=int, default=8710)
    mel_flags(sp)
    sp.add_argument(
        "--max-batch", type=int, default=256,
        help="row budget per device dispatch (largest dispatch shape)",
    )
    sp.add_argument(
        "--buckets", default=None,
        help="comma-separated dispatch-size ladder ending at max-batch "
        "(default: powers of two max-batch/8..max-batch); partial batches "
        "pad up to the smallest bucket instead of max-batch",
    )
    sp.add_argument(
        "--data-parallel", choices=("auto", "on", "off"), default="auto",
        help="accepted for compatibility; the port serves from one device "
        "(auto/off), 'on' is refused",
    )
    sp.add_argument(
        "--max-wait-ms", type=float, default=5.0,
        help="micro-batching window CAP: bursts ship when the row budget "
        "fills; otherwise the adaptive policy ships as soon as the arrival-"
        "rate estimate says the next bucket boundary is out of reach "
        "(--no-adaptive waits the full window instead)",
    )
    sp.add_argument(
        "--no-adaptive", action="store_true",
        help="disable the EWMA arrival-rate window (always wait max-wait-ms "
        "for a partial batch)",
    )
    sp.add_argument(
        "--checkpoint", default=None,
        help="a JAX-saved .msgpack payload or a torch.save state dict",
    )
    sp.add_argument(
        "--allow-random", action="store_true",
        help="serve randomly initialized weights (smoke tests only)",
    )
    sp.add_argument(
        "--workers", type=int, default=1,
        help="accepted for compatibility; only 1 (single process) is ported",
    )
    sp.set_defaults(fn=cmd_serve)
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
