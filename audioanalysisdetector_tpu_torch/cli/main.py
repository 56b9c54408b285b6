"""Command-line entry points of the PyTorch port.

  score          log-mel + CNN-BiLSTM spoof scoring over a directory of WAV/FLAC files
  serve          HTTP scoring service: dynamic micro-batching in front of one card
  train          CNN-BiLSTM training run on log-mel features (one device)
  train-fused    GMM(+)BiLSTM flagship system: CQCC -> BiLSTM + GMM-UBM -> fused EER
  train-asvspoof metadata-driven flagship recipe on an ASVspoof-layout corpus

The flags are those of the JAX package's commands, plus ``--device``.
Multi-device data parallelism (``serve --data-parallel on``), multi-process
serving (``--workers`` > 1) and augmentation (``train-asvspoof --augment``)
are not ported yet and are refused. Run as
``python -m audioanalysisdetector_tpu_torch score ...``.
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


def _require_decoded(paths: list[str], n_min: int) -> bool:
    """Re-validate corpus size AFTER decode drops unreadable files."""
    if len(paths) >= n_min:
        return True
    print(f"only {len(paths)} files decoded successfully — need at least {n_min}", file=sys.stderr)
    return False


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
    if not _require_decoded(paths, 4):
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


def _eval_fused_system(
    best_state, g_gen, g_spoof, tr, y_tr, te, y_te, *,
    batch_size: int, weight: float | str = 0.5, calibrate: bool = False,
    gmm_deltas: bool = False, gmm_cmvn: bool = False, device: str = "cuda",
):
    """Shared fused-system evaluation: per-arm diagnostics + fused metrics,
    the JAX package's ``_eval_fused_system`` on ``device``.

    Returns (gmm_metrics, fused_metrics, calibration): ``gmm_metrics`` is
    the GMM arm alone (LLR-ranking EER), ``calibration`` the (scale, bias,
    weight) used (1, 0, w unless ``calibrate``/auto-weight).
    ``weight="auto"`` picks the BiLSTM fusion weight on the TRAIN split (EER
    of the calibrated blend, ties toward the reference's 0.5); the
    reference's literal 0.5/0.5 stays the default
    (reference/ASV_dl_func.py:1448-1462). One device pass per split gives
    the arms; the fused score is a host formula of them.
    """
    import torch

    from audioanalysisdetector_tpu_torch.score.fused import (
        fit_decision_threshold,
        fit_llr_calibration,
        make_arm_scorer,
    )
    from audioanalysisdetector_tpu_torch.train import metrics as M
    from audioanalysisdetector_tpu_torch.train.gmm_system import make_gmm_feature_fn

    arms = make_arm_scorer(
        best_state.model, g_gen, g_spoof,
        gmm_feature_fn=make_gmm_feature_fn(deltas=gmm_deltas, cmvn=gmm_cmvn),
    )

    def run_arms(x):
        ps, ls, es = [], [], []
        for s in range(0, len(x), batch_size):
            xb = x[s : s + batch_size]
            nb = len(xb)
            if nb < batch_size:
                xb = np.concatenate([xb, np.repeat(xb[-1:], batch_size - nb, axis=0)])
            p, l, e = arms(torch.from_numpy(np.ascontiguousarray(xb, np.float32)).to(device))
            ps.append(p.cpu().numpy()[:nb])
            ls.append(l.cpu().numpy()[:nb])
            es.append(e.cpu().numpy()[:nb])
        return np.concatenate(ps), np.concatenate(ls), np.concatenate(es)

    def blend(p, llr, empty, w):
        z = np.clip(scale * llr + bias, -30.0, 30.0)
        f = w * p + (1.0 - w) / (1.0 + np.exp(-z))
        return np.where(empty, 0.5, f)  # empty-sequence rule, score/fused.py

    scale, bias = 1.0, 0.0
    op_threshold = 0.5  # the reference's decision contract
    auto_weight = weight == "auto"
    w = 0.5 if auto_weight else float(weight)
    if calibrate or auto_weight:
        p_tr, llr_tr, empty_tr = run_arms(tr)
        if calibrate:
            scale, bias = fit_llr_calibration(llr_tr, y_tr)
        if auto_weight:
            cands = np.round(np.linspace(0.0, 1.0, 21), 3)
            eers = np.array([M.eer(y_tr, blend(p_tr, llr_tr, empty_tr, c)) for c in cands])
            w = float(cands[np.lexsort((np.abs(cands - 0.5), eers))[0]])
        if calibrate:
            op_threshold = fit_decision_threshold(blend(p_tr, llr_tr, empty_tr, w), y_tr)
    p_te, llr_te, empty_te = run_arms(te)
    gmm_metrics = {"eer": M.eer(y_te, llr_te)}
    fused = blend(p_te, llr_te, empty_te, w)
    y_pred = (fused > 0.5).astype(np.int64)
    fused_metrics = {
        "accuracy": M.accuracy(y_te, y_pred),
        "f1": M.f1_binary(y_te, y_pred),
        "eer": M.eer(y_te, fused),
    }
    if auto_weight:
        fused_metrics["fusion_weight"] = w
    if calibrate:
        y_op = (fused > op_threshold).astype(np.int64)
        fused_metrics["op_threshold"] = float(op_threshold)
        fused_metrics["accuracy_at_op"] = M.accuracy(y_te, y_op)
        fused_metrics["f1_at_op"] = M.f1_binary(y_te, y_op)
    fused_metrics["_eval_scores"] = fused  # for the per-tier EER; not printed
    return gmm_metrics, fused_metrics, (scale, bias, w)


def _per_tier_eer(y: np.ndarray, scores: np.ndarray, attack: np.ndarray) -> dict:
    """EER of each spoof system vs ALL bonafide chunks — the ASVspoof
    challenge's own decomposition of the pooled number."""
    from audioanalysisdetector_tpu_torch.train import metrics as M

    y = np.asarray(y)
    bona = y == 0
    out = {}
    for tier in sorted(set(attack[y == 1])):
        sel = bona | ((y == 1) & (attack == tier))
        out[str(tier)] = M.eer(y[sel], scores[sel])
    return out


def cmd_train_fused(args) -> int:
    """The JAX package's ``train-fused`` on ``--device``: decode, CQCC on the
    device, the seeded 80/20 split, scaler, ``bilstm_pipeline``,
    ``train_gmm_system``, the fused evaluation; one JSON line of the
    BiLSTM, GMM and fused metrics."""
    import torch

    from audioanalysisdetector_tpu_torch.data.scaler import prepare_train_test_data
    from audioanalysisdetector_tpu_torch.frontend.cqcc import CQCCConfig, cqcc, transpose_cqcc
    from audioanalysisdetector_tpu_torch.train.gmm_system import train_gmm_system
    from audioanalysisdetector_tpu_torch.train.loop import bilstm_pipeline

    paths = _collect_wavs(args.audio)
    if len(paths) < 8:
        print("need at least 8 labeled WAVs", file=sys.stderr)
        return 1
    paths, wav = _load_batch(_shuffle(paths, args.seed), args.seconds, args.sr)
    if not _require_decoded(paths, 8):
        return 1
    y = _labels_from_dirnames(paths)
    with torch.no_grad():
        feats = transpose_cqcc(cqcc(torch.from_numpy(wav).to(args.device), CQCCConfig.for_sr(args.sr)))
    feats = feats.cpu().numpy()
    split = max(int(len(paths) * 0.8), 2)
    os.makedirs(args.run_dir, exist_ok=True)
    tr, te, _ = prepare_train_test_data(
        feats[:split], feats[split:], scaler_path=os.path.join(args.run_dir, "scaler.npz")
    )
    result, bilstm_metrics = bilstm_pipeline(
        (tr, y[:split]), (te, y[split:]),
        num_epochs=args.epochs, lr=args.lr, batch_size=args.batch_size,
        hidden=args.hidden, model_dir=args.run_dir, device=args.device,
    )
    _, g_gen, g_spoof = train_gmm_system(
        tr, y[:split], n_components=args.gmm_components, model_dir=args.run_dir,
        adapt_mode=args.map_adapt, deltas=args.gmm_deltas, cmvn=args.gmm_cmvn, device=args.device,
    )
    gmm_metrics, fused_metrics, _ = _eval_fused_system(
        result.best_state, g_gen, g_spoof, tr, y[:split], te, y[split:],
        batch_size=args.batch_size, weight=args.fusion_weight, calibrate=args.calibrate_llr,
        gmm_deltas=args.gmm_deltas, gmm_cmvn=args.gmm_cmvn, device=args.device,
    )
    fused_metrics.pop("_eval_scores", None)
    print(json.dumps({"bilstm": bilstm_metrics, "gmm": gmm_metrics, "fused": fused_metrics}))
    return 0


def cmd_train_asvspoof(args) -> int:
    """The reference's flagship recipe, metadata-driven, on ``--device``:
    metadata + FLAC/WAV folders -> 2-s chunks -> CQCC -> balance -> scale ->
    BiLSTM -> GMM-UBM + MAP -> fused eval (ASV_deep_learning.ipynb cells
    22-25); one JSON line with the JAX package's keys."""
    from audioanalysisdetector_tpu_torch.data.scaler import prepare_train_test_data
    from audioanalysisdetector_tpu_torch.train.gmm_system import train_gmm_system
    from audioanalysisdetector_tpu_torch.train.loop import bilstm_pipeline
    from audioanalysisdetector_tpu_torch.train.quality import build_cqcc_arrays

    if args.augment:
        print(
            "train-asvspoof: --augment is not ported to audioanalysisdetector_tpu_torch yet "
            "(ROADMAP Queue 1 step 11: augmentation)",
            file=sys.stderr,
        )
        return 2
    os.makedirs(args.run_dir, exist_ok=True)

    def build(metadata: str, name: str):
        return build_cqcc_arrays(
            metadata, args.audio_dir, name=name, sr=args.sr,
            sample_size=args.sample_size, extension=args.extension,
            rescue_dir=args.run_dir, seed=args.seed, balance=name == "train",
            return_attack=name == "eval", device=args.device,
        )

    x_tr, y_tr = build(args.train_metadata, "train")
    x_te, y_te, attack_te = build(args.eval_metadata, "eval")
    tr, te, _ = prepare_train_test_data(x_tr, x_te, scaler_path=os.path.join(args.run_dir, "scaler.npz"))
    result, bilstm_metrics = bilstm_pipeline(
        (tr, y_tr), (te, y_te),
        num_epochs=args.epochs, lr=args.lr, batch_size=args.batch_size,
        hidden=args.hidden, model_dir=args.run_dir, seed=args.seed, device=args.device,
    )
    _, g_gen, g_spoof = train_gmm_system(
        tr, y_tr, n_components=args.gmm_components, model_dir=args.run_dir,
        adapt_mode=args.map_adapt, deltas=args.gmm_deltas, cmvn=args.gmm_cmvn, device=args.device,
    )
    gmm_metrics, fused_metrics, calibration = _eval_fused_system(
        result.best_state, g_gen, g_spoof, tr, y_tr, te, y_te,
        batch_size=args.batch_size, weight=args.fusion_weight, calibrate=args.calibrate_llr,
        gmm_deltas=args.gmm_deltas, gmm_cmvn=args.gmm_cmvn, device=args.device,
    )
    fused_scores = fused_metrics.pop("_eval_scores")
    if set(attack_te) - {"-", "bonafide", "nan"}:
        fused_metrics["per_tier_eer"] = _per_tier_eer(y_te, fused_scores, attack_te)
    print(json.dumps({
        "bilstm": bilstm_metrics, "gmm": gmm_metrics, "fused": fused_metrics,
        "n_train": int(len(y_tr)), "n_eval": int(len(y_te)),
        "calibration": {"scale": calibration[0], "bias": calibration[1], "weight": calibration[2]},
    }))
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

    def device_flag(sp):
        sp.add_argument("--device", default="cuda", help="torch device the run uses")

    def _weight_arg(v: str):
        return v if v == "auto" else float(v)

    def fusion_flags(sp):
        sp.add_argument(
            "--map-adapt", choices=("means", "full"), default="means",
            help="MAP adaptation mode: 'means' (Reynolds-style, default) or "
            "'full' (the reference's means+vars+weights update — can "
            "destabilize the LLR; see train/gmm_system.py)",
        )
        sp.add_argument(
            "--fusion-weight", type=_weight_arg, default=0.5,
            help="BiLSTM weight in the fusion: a float (reference: 0.5) or "
            "'auto' to pick it on the train split (EER of the calibrated "
            "blend, ties toward 0.5)",
        )
        sp.add_argument(
            "--calibrate-llr", action="store_true",
            help="Platt-calibrate sigmoid(LLR) on the train split before fusing",
        )
        sp.add_argument(
            "--gmm-deltas", action="store_true",
            help="model CQCC+delta+delta-delta frames in the GMM arm (the "
            "classic ASVspoof CQCC-GMM recipe; the BiLSTM arm is unchanged)",
        )
        sp.add_argument(
            "--gmm-cmvn", action="store_true",
            help="per-utterance cepstral mean/variance normalization of the "
            "GMM arm's frames (cancels convolutional channel offsets; the "
            "BiLSTM arm is unchanged)",
        )

    sp = sub.add_parser("train-fused", help="GMM(+)BiLSTM flagship system")
    sp.add_argument("audio", help="WAV/FLAC directory or glob ('spoof'/'fake' dirs are label 1)")
    sp.add_argument("--sr", type=int, default=16000)
    sp.add_argument("--seconds", type=float, default=2.0)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--epochs", type=int, default=5)
    sp.add_argument("--batch-size", type=int, default=16)
    sp.add_argument("--lr", type=float, default=1e-4)
    sp.add_argument("--hidden", type=int, default=128)
    sp.add_argument("--gmm-components", type=int, default=16)
    sp.add_argument("--run-dir", default="runs/GMM-BiLSTM")
    fusion_flags(sp)
    device_flag(sp)
    sp.set_defaults(fn=cmd_train_fused)

    sp = sub.add_parser(
        "train-asvspoof",
        help="metadata-driven flagship recipe on an ASVspoof-layout corpus",
    )
    sp.add_argument("train_metadata", help="whitespace metadata file (train)")
    sp.add_argument("eval_metadata", help="whitespace metadata file (eval)")
    sp.add_argument("--audio-dir", nargs="+", required=True,
                    help="folder(s) holding the FLAC/WAV files")
    sp.add_argument("--extension", default=".flac")
    sp.add_argument("--sr", type=int, default=16000)
    sp.add_argument("--sample-size", type=int, default=None)
    sp.add_argument("--epochs", type=int, default=50)
    sp.add_argument("--lr", type=float, default=1e-4)
    sp.add_argument("--batch-size", type=int, default=16)
    sp.add_argument("--hidden", type=int, default=128)
    sp.add_argument("--gmm-components", type=int, default=128)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--run-dir", default="GMM-BiLSTM")
    sp.add_argument(
        "--augment", action="store_true",
        help="accepted for compatibility; augmentation is not ported yet and is refused",
    )
    fusion_flags(sp)
    device_flag(sp)
    sp.set_defaults(fn=cmd_train_asvspoof)

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
