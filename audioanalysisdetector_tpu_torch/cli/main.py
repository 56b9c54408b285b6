"""Command-line entry points of the PyTorch port.

  score          log-mel + CNN-BiLSTM (or SSL-AASIST, WavLM-MHFA) spoof scoring over WAV/FLAC files
  extract        feature extraction (mfcc/lfcc/cqcc/gtcc/wpt/mel_spectrogram/mfcc_deltas) to .npz
  augment        augmentation on the device: writes noise, pitch and shift WAVs
  serve          HTTP scoring service: dynamic micro-batching in front of the card
                 (one process, or --workers N HTTP processes and one card owner)
  train          CNN-BiLSTM training run on log-mel features
  train-fused    GMM(+)BiLSTM flagship system: CQCC -> BiLSTM + GMM-UBM -> fused EER
  train-asvspoof metadata-driven flagship recipe on an ASVspoof-layout corpus
  train-3features  shared-trunk (cqcc, gtcc, mfcc) fusion net (notebook cells 32-33)
  train-mfca     MobileNetV2+MFCA on log-mel (notebook cells 29-31)
  xai            attribution heatmaps (saliency, Grad-CAM, IG, occlusion, LIME) for one WAV
  gridsearch     classical SVM / gradient-boosting sweep over feature sets, reducers, components
  classical      metadata-driven classical pipeline: 6 features -> expand -> PCA+SVC / PCA+HGB grids

The flags are those of the JAX package's commands, plus ``--device``.
``serve --data-parallel`` splits each dispatch over the local cards;
``train`` joins a launcher's process group when one is set (``torchrun``),
and then trains data-parallel with sync-BN as the JAX package does over
its local devices. Run as ``python -m audioanalysisdetector_tpu_torch score ...``.
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
    metrics on stdout, the run's kernel launch counts on stderr.

    Under a launcher's process group (``initialize_distributed`` reads
    ``torchrun``'s environment; without one this is one process), the
    model is built with sync-BN when ``would_use_dp`` says ``fit`` shards
    the batch, which then opts in with ``data_parallel=True``: the sharded
    step is numerically the global-batch step."""
    import torch

    from audioanalysisdetector_tpu_torch.frontend.mel import MelConfig, log_mel_spectrogram
    from audioanalysisdetector_tpu_torch.models.cnn_bilstm import CNNBiLSTMHybrid
    from audioanalysisdetector_tpu_torch.models.layers import flax_init_
    from audioanalysisdetector_tpu_torch.parallel.mesh import initialize_distributed
    from audioanalysisdetector_tpu_torch.train import TrainState, evaluate, fit, make_optimizer
    from audioanalysisdetector_tpu_torch.train.loop import would_use_dp

    initialize_distributed(device=args.device)

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
    use_dp = would_use_dp(args.batch_size)  # the decision fit() will make
    model = CNNBiLSTMHybrid(feats.shape[-1], logits=True, bn_axis_name="data" if use_dp else None)
    flax_init_(model, torch.Generator().manual_seed(args.seed))
    state = TrainState.create(model=model.to(args.device), tx=make_optimizer(args.optimizer, args.lr))
    result = fit(
        state, (feats[:split], y[:split]), (feats[split:], y[split:]),
        loss_name="BCELoss", num_epochs=args.epochs, batch_size=args.batch_size,
        seed=args.seed, run_dir=args.run_dir, binary_head=True, verbose=True,
        data_parallel=True if use_dp else None,
    )
    metrics = evaluate(
        result.best_state, (feats[split:], y[split:]), loss_name="BCELoss", binary_head=True
    )
    print(json.dumps(metrics))
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

    os.makedirs(args.run_dir, exist_ok=True)

    def build(metadata: str, name: str):
        return build_cqcc_arrays(
            metadata, args.audio_dir, name=name, sr=args.sr,
            sample_size=args.sample_size, extension=args.extension,
            rescue_dir=args.run_dir, seed=args.seed, balance=name == "train",
            return_attack=name == "eval", augment=args.augment and name == "train",
            device=args.device,
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


def cmd_train_3features(args) -> int:
    """The JAX package's ``train-3features`` on ``--device``: decode, CQCC,
    GFCC and MFCC made on the device under ``torch.no_grad()`` (CQCC and GFCC
    plain torch, MFCC's 128-mel power through K3 on the card), the seeded
    80/20 split, ``train_3features``; one JSON line of the best state's
    metrics on stdout, the run's kernel launch counts on stderr."""
    import torch

    from audioanalysisdetector_tpu_torch.frontend.cepstral import CepstralConfig, gfcc
    from audioanalysisdetector_tpu_torch.frontend.cqcc import CQCCConfig, cqcc
    from audioanalysisdetector_tpu_torch.frontend.mfcc import MFCCConfig, mfcc
    from audioanalysisdetector_tpu_torch.train.sweep import train_3features

    paths = _collect_wavs(args.audio)
    if len(paths) < 8:
        print("need at least 8 labeled WAVs", file=sys.stderr)
        return 1
    paths, wav = _load_batch(_shuffle(paths, args.seed), args.seconds, args.sr)
    if not _require_decoded(paths, 8):
        return 1
    y = _labels_from_dirnames(paths)
    with torch.no_grad():
        w = torch.from_numpy(wav).to(args.device)
        feats = (
            cqcc(w, CQCCConfig.for_sr(args.sr)),
            # gtcc stays in its spafe (T, 13) layout, as the reference's
            # MultiFeatureDataset feeds it (the trunk is shape-agnostic)
            gfcc(w, CepstralConfig(fs=args.sr, nfilts=40, fb_kind="gammatone")),
            mfcc(w, MFCCConfig.for_sr(args.sr)),
        )
    split = max(int(len(paths) * 0.8), 2)
    out = train_3features(
        tuple(f[:split] for f in feats), y[:split],
        tuple(f[split:] for f in feats), y[split:],
        epochs=args.epochs, lr=args.lr, batch_size=args.batch_size,
        out_dir=args.run_dir, seed=args.seed, device=args.device,
    )
    print(json.dumps(out["best"]))
    return 0


def cmd_train_mfca(args) -> int:
    """The JAX package's ``train-mfca`` on ``--device``: log-mel
    (``MelConfig(sr, n_mels)``, K3 on the card) under ``torch.no_grad()``,
    the seeded 80/20 split, ``train_mfca``; one JSON line of the best
    state's metrics, the kernel launch counts on stderr."""
    import torch

    from audioanalysisdetector_tpu_torch.frontend.mel import MelConfig, log_mel_spectrogram
    from audioanalysisdetector_tpu_torch.train.sweep import train_mfca

    paths = _collect_wavs(args.audio)
    if len(paths) < 8:
        print("need at least 8 labeled WAVs", file=sys.stderr)
        return 1
    paths, wav = _load_batch(_shuffle(paths, args.seed), args.seconds, args.sr)
    if not _require_decoded(paths, 8):
        return 1
    y = _labels_from_dirnames(paths)
    with torch.no_grad():
        feats = log_mel_spectrogram(torch.from_numpy(wav).to(args.device), MelConfig(sr=args.sr, n_mels=args.n_mels))
    split = max(int(len(paths) * 0.8), 2)
    out = train_mfca(
        feats[:split], y[:split], feats[split:], y[split:],
        epochs=args.epochs, lr=args.lr, batch_size=args.batch_size,
        out_dir=args.run_dir, seed=args.seed, device=args.device,
    )
    print(json.dumps(out["best"]))
    return 0


def cmd_xai(args) -> int:
    """The JAX package's ``xai`` on ``--device``: the first file's log-mel
    (``MelConfig(sr, n_mels)``, K3 on the card) under ``torch.no_grad()``,
    an ``AntiSpoofingResNet`` from ``flax_init_`` seeded 0 (the JAX command's
    ``PRNGKey(0)``; no checkpoint, as there), the chosen attributions, their
    PNGs (skipped without matplotlib) and the optional HTML page. stdout:
    the LIME line when asked, then the written paths; stderr: the kernel
    launch counts. Heatmaps are (T, F): the (F, T) maps transposed."""
    import torch

    from audioanalysisdetector_tpu_torch.frontend.mel import MelConfig, log_mel_spectrogram
    from audioanalysisdetector_tpu_torch.models.layers import flax_init_
    from audioanalysisdetector_tpu_torch.models.resnet import AntiSpoofingResNet
    from audioanalysisdetector_tpu_torch.score.fused import ieee_fp32
    from audioanalysisdetector_tpu_torch.xai import (
        grad_cam,
        integrated_gradients,
        lime_single_instance,
        occlusion,
        plot_gradcam_overlay,
        plot_heatmaps,
        saliency,
        write_explanation_html,
    )

    ieee_fp32()
    paths = _collect_wavs(args.audio)[:1]
    if not paths:
        print(f"no WAV files under {args.audio}", file=sys.stderr)
        return 1
    paths, wav = _load_batch(paths, args.seconds, args.sr)
    if not paths:
        print("no readable WAV files", file=sys.stderr)
        return 1
    mel_cfg = MelConfig(sr=args.sr, n_mels=args.n_mels)
    with torch.no_grad():
        feats = log_mel_spectrogram(torch.from_numpy(wav).to(args.device), mel_cfg)
    model = flax_init_(AntiSpoofingResNet(), torch.Generator().manual_seed(0)).to(args.device).eval()

    def host(t: torch.Tensor) -> np.ndarray:
        return t.detach().cpu().numpy()

    methods = args.methods.split(",")
    heatmaps = {}
    out = []
    if "saliency" in methods:
        heatmaps["saliency"] = host(saliency(model, feats)[0]).T  # (F, T) -> plot contract (T, F)
    if "gradcam" in methods:
        cam = grad_cam(model, feats, output_size=tuple(feats.shape[-2:]))
        heatmaps["grad_cam"] = host(cam[0]).T
        # the notebook's overlay-on-mel-axes figure (cell 34)
        overlay = plot_gradcam_overlay(
            host(feats[0]), host(cam[0]), sr=args.sr, hop_length=mel_cfg.hop_length,
            fmax=mel_cfg.fmax, out_path=os.path.join(args.output_dir, "gradcam_overlay.png"),
        )
    if "ig" in methods:
        ig = integrated_gradients(model, feats, steps=args.ig_steps)
        heatmaps["integrated_gradients"] = np.abs(host(ig[0])).T
    if "occlusion" in methods:
        # feats are coefficients-first (B, n_mels, T); the reference's (5, 1)
        # window means 5 TIME frames x 1 coefficient (tets_xai.py:84), so on
        # this layout the window is (1 mel bin, 5 frames)
        heatmaps["occlusion"] = host(occlusion(model, feats, window=(1, 5))[0]).T
    if "lime" in methods:
        @torch.no_grad()
        def scorer(batch):
            return torch.softmax(model(batch), dim=-1)[:, 1]

        lime = lime_single_instance(scorer, feats[0], n_perturbations=args.lime_perturbations)
        print(json.dumps({
            "lime_top_components": lime["top_components"],
            "lime_score": lime["score"],
            "lime_label": lime["label"],
        }))
    out += plot_heatmaps(heatmaps, args.output_dir, prefix=os.path.splitext(os.path.basename(paths[0]))[0])
    if "gradcam" in methods and overlay is not None:
        out.append(overlay)
    if args.html:
        with torch.no_grad():
            probs = torch.softmax(model(feats), dim=-1)
        out.append(write_explanation_html(
            os.path.join(args.output_dir, "explanation.html"),
            score=float(probs[0, 1]), heatmaps=heatmaps,
            title=f"Explanation: {os.path.basename(paths[0])}",
        ))
    if out:
        print("\n".join(out))
    return 0


def cmd_score(args) -> int:
    """Stream-decode the files and score them on ``--device``: one JSON
    line per file on stdout, then the kernel launch counts of the run as one
    JSON line on stderr. ``--model xlsr-aasist`` scores with SSL-AASIST:
    64,600 samples at 16 kHz, a short clip repeated to fill them
    (``tile_pad``), and the bona fide logit as the score; ``--model
    wavlm-mhfa`` with WavLM-Large + MHFA and ``--model w2vbert-mhfa`` with
    w2v-BERT 2.0 + MHFA the same way, on 256,000 samples; ``--model
    whisper-mhfa`` with Whisper large-v3's encoder + MHFA on 480,000
    samples (30 s), a short clip zero-padded and a long one trimmed, as the
    published extractor does; ``--model voxtral-detect`` with Voxtral-Mini-3B
    read as a detector on whole clips (``_score_voxtral``)."""
    from audioanalysisdetector_tpu_torch.frontend.mel import MelConfig
    from audioanalysisdetector_tpu_torch.score.e2e import (
        init_mel_cnn_bilstm,
        make_mel_cnn_bilstm_scorer,
    )
    from audioanalysisdetector_tpu_torch.score.streaming import score_paths

    if not args.checkpoint and not args.allow_random:
        print(
            "score: no --checkpoint given — scores from randomly initialized "
            "weights are meaningless. Pass --checkpoint <best_model.msgpack> "
            "(a JAX-saved payload) or <state_dict.pt> (torch.save; for "
            "--model xlsr-aasist the published LA_model.pth, for --model "
            "wavlm-mhfa the published WavLM-Large front end, for --model "
            "w2vbert-mhfa the published w2v-BERT 2.0 front end, for --model "
            "whisper-mhfa the published Whisper large-v3 model, for --model "
            "voxtral-detect the published Voxtral-Mini-3B), "
            "or --allow-random to proceed anyway (smoke tests only).",
            file=sys.stderr,
        )
        return 2
    paths = _collect_wavs(args.audio)
    if not paths:
        print(f"no WAV files under {args.audio}", file=sys.stderr)
        return 1
    if args.model in ("xlsr-aasist", "wavlm-mhfa", "w2vbert-mhfa", "whisper-mhfa"):
        return _score_ssl(args, paths)
    if args.model == "voxtral-detect":
        return _score_voxtral(args, paths)
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
    return 0


def _score_ssl(args, paths: list[str]) -> int:
    """``--model xlsr-aasist``, ``wavlm-mhfa``, ``w2vbert-mhfa`` or
    ``whisper-mhfa``: raw 16-kHz samples, tiled (Whisper: zero-padded) and
    cut to the model's input, one bona fide logit a file. The 16-s and 30-s
    models take at most 32 clips a call: WavLM-MHFA's first conv map alone
    is 105 MB a clip, w2v-BERT's attention mask 41 MB a clip and layer,
    Whisper's 33 hidden states 253 MB a clip."""
    from audioanalysisdetector_tpu_torch.score import e2e
    from audioanalysisdetector_tpu_torch.score.streaming import score_paths

    sr, n, init, make, most, pad = {
        "xlsr-aasist": (e2e.XLSR_AASIST_SR, e2e.XLSR_AASIST_SAMPLES, e2e.init_xlsr_aasist,
                        e2e.make_xlsr_aasist_scorer, args.batch_size, "tile"),
        "wavlm-mhfa": (e2e.WAVLM_MHFA_SR, e2e.WAVLM_MHFA_SAMPLES, e2e.init_wavlm_mhfa, e2e.make_wavlm_mhfa_scorer,
                       32, "tile"),
        "w2vbert-mhfa": (e2e.W2VBERT_MHFA_SR, e2e.W2VBERT_MHFA_SAMPLES, e2e.init_w2vbert_mhfa,
                         e2e.make_w2vbert_mhfa_scorer, 32, "tile"),
        "whisper-mhfa": (e2e.WHISPER_MHFA_SR, e2e.WHISPER_MHFA_SAMPLES, e2e.init_whisper_mhfa,
                         e2e.make_whisper_mhfa_scorer, 32, "zeros"),
    }[args.model]
    if args.sr != sr:
        print(f"score: --model {args.model} takes {sr} Hz audio, not --sr {args.sr}", file=sys.stderr)
        return 2
    model = init(checkpoint=args.checkpoint, device=args.device)
    kept, scores = score_paths(
        make(model), paths, device=args.device, seconds=n / sr, sr=sr,
        batch_size=min(args.batch_size, most), pad=pad,
    )
    for p, s in zip(kept, scores):
        print(json.dumps({"file": p, "bonafide_logit": float(s)}))
    return 0


def _score_voxtral(args, paths: list[str]) -> int:
    """``--model voxtral-detect``: each file decoded whole at 16 kHz and
    zero-padded to the next multiple of 30 s, as ``VoxtralProcessor`` pads
    it (an empty file to one window); clips of equal window count scored
    together, ``--batch-size`` clips a call at most; one bona fide score a
    file, in the files' order. A file that cannot be decoded is skipped
    with a warning. Memory: the weights' 18.7 GB and ~0.1 GB a window (2
    clips of 300 s peak at 20.6 GB on an H100), so long clips want a
    smaller ``--batch-size`` than the default."""
    import wave

    import torch

    from audioanalysisdetector_tpu_torch.io.audio import load_audio
    from audioanalysisdetector_tpu_torch.score import e2e

    if args.sr != e2e.VOXTRAL_SR:
        print(f"score: --model voxtral-detect takes {e2e.VOXTRAL_SR} Hz audio, not --sr {args.sr}",
              file=sys.stderr)
        return 2
    model = e2e.init_voxtral_detect(checkpoint=args.checkpoint, device=args.device)
    score = e2e.make_voxtral_detect_scorer(model)
    window = model.window_samples
    groups: dict[int, list[tuple[str, np.ndarray]]] = {}
    scores: dict[str, float] = {}

    def flush(w: int) -> None:
        kept = groups.pop(w)
        batch = torch.from_numpy(np.stack([row for _, row in kept])).to(args.device)
        for (p, _), s in zip(kept, score(batch).tolist()):
            scores[p] = s

    for p in paths:
        try:
            y = load_audio(p, sr=e2e.VOXTRAL_SR)[0]
        except (OSError, EOFError, ValueError, RuntimeError, wave.Error) as e:
            print(f"WARNING: cannot read {p}: skipped ({e})", file=sys.stderr)
            continue
        w = max(1, -(-len(y) // window))
        row = np.zeros(w * window, np.float32)
        row[:len(y)] = y
        groups.setdefault(w, []).append((p, row))
        if len(groups[w]) >= args.batch_size:
            flush(w)
    for w in list(groups):
        flush(w)
    for p in paths:
        if p in scores:
            print(json.dumps({"file": p, "bonafide_score": scores[p]}))
    return 0


def cmd_extract(args) -> int:
    """Stream-decode the files and run one registry extractor on
    ``--device``; write ``features`` and ``files`` to an ``.npz``. Feature
    tensors are large, so only a 2-batch window stays on the device: older
    batches are fetched to the host as new ones are dispatched. The run's
    kernel launch counts go to stderr as one JSON line."""
    import torch

    from audioanalysisdetector_tpu_torch.data.pipeline import default_extractors
    from audioanalysisdetector_tpu_torch.score.streaming import stream_decode_batches

    paths = _collect_wavs(args.audio)
    if not paths:
        print(f"no WAV files under {args.audio}", file=sys.stderr)
        return 1
    registry = default_extractors(args.sr)
    if args.feature not in registry:
        print(f"unknown feature {args.feature}; options: {sorted(registry)}", file=sys.stderr)
        return 1
    feature_fn = registry[args.feature]
    kept_all: list[str] = []
    host_parts: list[np.ndarray] = []
    window: list[torch.Tensor] = []
    with torch.no_grad():
        for kept, batch_np in stream_decode_batches(
            paths, seconds=args.seconds, sr=args.sr, batch_size=args.batch_size
        ):
            kept_all.extend(kept)
            window.append(feature_fn(torch.from_numpy(batch_np).to(args.device)))
            if len(window) > 2:
                host_parts.append(window.pop(0).cpu().numpy())
    host_parts.extend(f.cpu().numpy() for f in window)
    if not host_parts:
        print("no decodable audio files — nothing extracted", file=sys.stderr)
        return 1
    feats = np.concatenate(host_parts)
    np.savez(args.output, features=feats, files=np.asarray(kept_all))
    print(f"wrote {feats.shape} {args.feature} features to {args.output}")
    return 0


def cmd_augment(args) -> int:
    """Decode the files, make the noise, pitch and shift variants on
    ``--device`` (one generator seeded from ``--seed``), write each as a
    16-bit WAV."""
    import torch

    from audioanalysisdetector_tpu_torch.data.augment import add_noise, pitch_shift, time_shift
    from audioanalysisdetector_tpu_torch.io.audio import write_wav

    paths = _collect_wavs(args.audio)
    if not paths:
        print(f"no WAV files under {args.audio}", file=sys.stderr)
        return 1
    paths, wav_np = _load_batch(paths, args.seconds, args.sr)
    wav = torch.from_numpy(wav_np).to(args.device)
    os.makedirs(args.output_dir, exist_ok=True)
    generator = torch.Generator(device=args.device).manual_seed(args.seed)
    with torch.no_grad():
        variants = {
            "noise": add_noise(wav, generator, factor=args.noise_factor),
            "pitch": pitch_shift(wav, n_steps=args.pitch_steps),
            "shift": time_shift(wav, generator),
        }
    for name, batch in variants.items():
        for p, y in zip(paths, batch.cpu().numpy()):
            base = os.path.splitext(os.path.basename(p))[0]
            write_wav(os.path.join(args.output_dir, f"{base}_{name}.wav"), y, args.sr)
    print(f"wrote {len(paths) * len(variants)} augmented files to {args.output_dir}")
    return 0


def cmd_classical(args) -> int:
    """Metadata-driven classical-ML end-to-end (reference/train_fun.py:305-403):
    sample caps, 6-feature extraction incl. formants, dict expansion,
    PCA+SVC / PCA+HGB grids with the pipeline cache, on ``--device``. The
    result is one JSON line; the kernel launch counts go to stderr."""
    from audioanalysisdetector_tpu_torch.train.classical import classical_main

    all_data = {}
    if args.config:
        # reference-style config.yaml: datasets.{KEY}.{metadata, flac}
        # (reference/train_fun.py:30-44; schema in io/config.py)
        from audioanalysisdetector_tpu_torch.io.config import load_config

        cfg = load_config(args.config)
        for key, block in cfg.get("datasets", {}).items():
            flac = block["flac"]
            all_data[key] = {
                "metadata": block["metadata"],
                "flac": list(flac) if isinstance(flac, list) else [flac],
            }
    for spec in args.dataset or []:
        try:
            key, metadata, audio_dir = spec.split(":", 2)
        except ValueError:
            print(f"bad --dataset spec {spec!r}; use KEY:METADATA:AUDIO_DIR", file=sys.stderr)
            return 2
        entry = all_data.setdefault(key, {"metadata": metadata, "flac": []})
        entry["flac"].append(audio_dir)
    if not all_data:
        print("classical: provide --dataset specs and/or --config", file=sys.stderr)
        return 2
    features = tuple(f.strip() for f in args.features.split(",") if f.strip())
    try:
        out = classical_main(
            all_data,
            sr=args.sr,
            seconds=args.seconds,
            features=features,
            pca_components=tuple(int(c) for c in args.components.split(",") if c.strip()),
            extension=args.extension,
            cache_dir=args.cache_dir,
            seed=args.seed,
            device=args.device,
        )
    except ValueError as e:
        print(f"classical: {e}", file=sys.stderr)
        return 1
    print(json.dumps(out))
    return 0


def cmd_gridsearch(args) -> int:
    """Extract the features of labelled files on ``--device``, expand them,
    split 80/20 and run ``run_extensive_gridsearch`` (its CSVs under
    ``--output-dir``); print the top rows, one JSON line each. The kernel
    launch counts go to stderr."""
    from audioanalysisdetector_tpu_torch.data.pipeline import extract_features
    from audioanalysisdetector_tpu_torch.train.classical import (
        expand_feature_columns,
        run_extensive_gridsearch,
    )

    paths = _collect_wavs(args.audio)
    if len(paths) < 10:
        print("need at least 10 labeled WAVs", file=sys.stderr)
        return 1
    paths = _shuffle(paths, args.seed)
    features = [f.strip() for f in args.features.split(",") if f.strip()]
    components = tuple(int(c) for c in args.components.split(",") if c.strip())
    rows = [{"file_path": p, "label": int(lab), "chunk_start": 0.0, "chunk_end": args.seconds}
            for p, lab in zip(paths, _labels_from_dirnames(paths))]
    rows = extract_features(rows, features, sr=args.sr, mean=True, device=args.device)
    expanded = expand_feature_columns(rows, features, "label")
    columns = list(expanded[0]) if expanded else []
    groups = {f: [c for c in columns if c == f or c.startswith(f + "_")] for f in features}
    split = int(len(expanded) * 0.8)
    _, full = run_extensive_gridsearch(
        expanded[:split], expanded[split:], feature_groups=groups,
        components=components, out_dir=args.output_dir,
        cache_dir=args.cache_dir, device=args.device,
    )
    for row in (full or [])[: args.top_k]:
        print(json.dumps(row, default=str))
    return 0


_DATA_PARALLEL = {"auto": None, "on": True, "off": False}


def _serve_multiprocess(args) -> int:
    """--workers N > 1: SO_REUSEPORT scale-out (serve/multiproc.py). One
    spawned process owns the card and the batcher; N HTTP workers share
    the port and forward rows to it, so the host's parse and decode scale
    with cores while batching still aggregates globally. Serves until
    SIGINT or SIGTERM, then stops every process it started."""
    import signal
    import time

    from audioanalysisdetector_tpu_torch.serve.multiproc import MultiprocessServer
    from audioanalysisdetector_tpu_torch.serve.server import default_bucket_ladder

    if args.buckets:
        buckets = tuple(int(b) for b in args.buckets.split(","))
    else:
        buckets = default_bucket_ladder(args.max_batch)
    srv = MultiprocessServer(
        workers=args.workers,
        sr=args.sr,
        host=args.host,
        port=args.port,
        factory_kwargs=dict(
            checkpoint=args.checkpoint,
            sr=args.sr,
            seconds=args.seconds,
            n_mels=args.n_mels,
            mel_profile=args.mel_profile,
            data_parallel=_DATA_PARALLEL[args.data_parallel],
            device=args.device,
        ),
        batcher_kwargs=dict(
            max_batch=args.max_batch,
            max_wait_ms=args.max_wait_ms,
            bucket_sizes=buckets,
            adaptive=not args.no_adaptive,
        ),
        force_cpu=args.device == "cpu",
    )

    def _stop(signum, frame):
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, _stop)
    try:
        srv.start()
        print(
            json.dumps(
                {
                    "listening": f"http://{args.host}:{srv.port}",
                    "endpoints": ["/v1/score", "/v1/score_raw", "/v1/stats", "/healthz"],
                    "workers": args.workers,
                    "max_batch": args.max_batch,
                    "buckets": list(buckets),
                    "device": args.device,
                }
            ),
            flush=True,
        )
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        srv.close()
    return 0


def cmd_serve(args) -> int:
    """HTTP scoring service (serve/server.py): build the scorer, warm up
    every bucket, bind, serve until SIGINT. ``--workers`` > 1 runs the
    multi-process server (``_serve_multiprocess``)."""
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
    if args.workers > 1:
        return _serve_multiprocess(args)
    try:
        scorer, n_samples = build_mel_scorer(
            checkpoint=args.checkpoint,
            sr=args.sr,
            seconds=args.seconds,
            n_mels=args.n_mels,
            mel_profile=args.mel_profile,
            data_parallel=_DATA_PARALLEL[args.data_parallel],
            device=args.device,
        )
    except ValueError as e:
        print(f"serve: {e}", file=sys.stderr)
        return 2
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
                "data_parallel_devices": scorer.row_multiple,
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

    sp = sub.add_parser("score", help="log-mel + CNN-BiLSTM (or SSL-AASIST, WavLM-MHFA, w2v-BERT-MHFA, "
                        "Whisper-MHFA, Voxtral) spoof scoring")
    sp.add_argument("audio", help="WAV/FLAC directory or glob")
    mel_flags(sp)
    sp.add_argument(
        "--model", choices=("cnn-bilstm", "xlsr-aasist", "wavlm-mhfa", "w2vbert-mhfa", "whisper-mhfa",
                            "voxtral-detect"),
        default="cnn-bilstm",
        help="cnn-bilstm: log-mel + CNN-BiLSTM, a spoof probability; "
        "xlsr-aasist: SSL-AASIST (XLS-R 300M + AASIST) on 64,600 raw "
        "samples; wavlm-mhfa: WavLM-Large + MHFA on 256,000 raw samples "
        "(16 s); w2vbert-mhfa: w2v-BERT 2.0 + MHFA on the same 16 s; "
        "the three repeat short clips; whisper-mhfa: Whisper large-v3's "
        "encoder + MHFA on 480,000 samples (30 s), short clips zero-padded; "
        "the four give the bona fide logit; voxtral-detect: Voxtral-Mini-3B "
        "as a detector on whole clips padded to a multiple of 30 s, the margin "
        "of its two answer logits "
        "(--seconds and the mel flags do not apply)",
    )
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
    sp.set_defaults(fn=cmd_score, report_launches=True)

    def clip_flags(sp):
        sp.add_argument("audio", help="WAV/FLAC directory or glob")
        sp.add_argument("--sr", type=int, default=16000)
        sp.add_argument("--seconds", type=float, default=2.0)
        sp.add_argument("--seed", type=int, default=0)
        sp.add_argument("--device", default="cuda", help="torch device the run uses")

    sp = sub.add_parser("extract", help="feature extraction to .npz")
    clip_flags(sp)
    sp.add_argument("--feature", default="cqcc")
    sp.add_argument("--output", default="features.npz")
    sp.add_argument("--batch-size", type=int, default=512)
    sp.set_defaults(fn=cmd_extract, report_launches=True)

    sp = sub.add_parser("augment", help="augmentation on the device: writes augmented WAVs")
    clip_flags(sp)
    sp.add_argument("--output-dir", default="augmented")
    sp.add_argument("--noise-factor", type=float, default=0.005)
    sp.add_argument("--pitch-steps", type=float, default=2.0)
    sp.set_defaults(fn=cmd_augment)

    sp = sub.add_parser("train", help="CNN-BiLSTM training run")
    sp.add_argument("audio", help="WAV/FLAC directory or glob ('spoof'/'fake' dirs are label 1)")
    mel_flags(sp)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--epochs", type=int, default=5)
    sp.add_argument("--batch-size", type=int, default=16)
    sp.add_argument("--lr", type=float, default=1e-4)
    sp.add_argument("--optimizer", default="Adam", help="Adam, AdamW, SGD or RMSprop")
    sp.add_argument("--run-dir", default="runs/cnn_bilstm")
    sp.set_defaults(fn=cmd_train, report_launches=True)

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
        help="expand the TRAIN split with the reference's augmentation "
        "policy (p=0.8 one of pitch/noise, p=0.5 both), applied on the "
        "device during extraction",
    )
    fusion_flags(sp)
    device_flag(sp)
    sp.set_defaults(fn=cmd_train_asvspoof)

    sp = sub.add_parser("train-3features", help="3-feature (cqcc+gtcc+mfcc) shared-trunk fusion net")
    clip_flags(sp)
    sp.add_argument("--epochs", type=int, default=50)
    sp.add_argument("--batch-size", type=int, default=16)
    sp.add_argument("--lr", type=float, default=1e-4)
    sp.add_argument("--run-dir", default="runs/MoreFeatures")
    sp.set_defaults(fn=cmd_train_3features, report_launches=True)

    sp = sub.add_parser("train-mfca", help="MobileNetV2+MFCA on log-mel")
    clip_flags(sp)
    sp.add_argument("--n-mels", type=int, default=64)
    sp.add_argument("--epochs", type=int, default=20)
    sp.add_argument("--batch-size", type=int, default=32)
    sp.add_argument("--lr", type=float, default=1e-4)
    sp.add_argument("--run-dir", default="runs/MobileNet-MFCA")
    sp.set_defaults(fn=cmd_train_mfca, report_launches=True)

    sp = sub.add_parser("xai", help="attribution heatmaps for one WAV")
    clip_flags(sp)
    sp.add_argument("--n-mels", type=int, default=64)
    sp.add_argument("--output-dir", default="xai_out")
    sp.add_argument("--methods", default="saliency,gradcam",
                    help="comma list: saliency,gradcam,ig,occlusion,lime")
    sp.add_argument("--ig-steps", type=int, default=20)
    sp.add_argument("--lime-perturbations", type=int, default=30)
    sp.add_argument("--html", action="store_true",
                    help="also write a self-contained explanation.html")
    sp.set_defaults(fn=cmd_xai, report_launches=True)

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
        help="split each dispatch's rows over the local cards, one model "
        "replica each (auto: when more than one card is visible)",
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
        help="HTTP worker processes sharing the port (SO_REUSEPORT) in "
        "front of one card-owner process (1: single process)",
    )
    sp.set_defaults(fn=cmd_serve)

    sp = sub.add_parser("gridsearch", help="classical SVM / gradient-boosting sweep")
    clip_flags(sp)
    sp.add_argument("--output-dir", default="gridsearch_results")
    sp.add_argument("--top-k", type=int, default=5)
    sp.add_argument(
        "--features", default="wpt,mfcc,lfcc",
        help="comma list of extractors swept as feature sets; 'formants' "
        "adds the Burg-LPC prosodic dict (reference: 6 features)",
    )
    sp.add_argument(
        "--components", default="10,20,30,40",
        help="comma list of PCA/ICA component counts (the reference's space)",
    )
    sp.add_argument(
        "--cache-dir", default=None,
        help="directory caching fitted pipeline prefixes across the sweep",
    )
    sp.set_defaults(fn=cmd_gridsearch, report_launches=True)

    sp = sub.add_parser(
        "classical",
        help="metadata-driven classical pipeline: 6 features incl. formants "
        "-> expand -> PCA+SVC / PCA+HGB grids (reference train_fun.main)",
    )
    sp.add_argument(
        "--dataset", action="append", default=None, metavar="KEY:METADATA:AUDIO_DIR",
        help="repeatable; KEY picks the sample cap (LA 5000, others 2500)",
    )
    sp.add_argument(
        "--config", default=None,
        help="reference-style config.yaml with a datasets.{KEY}.{metadata,"
        "flac} block (merged with --dataset specs)",
    )
    sp.add_argument("--sr", type=int, default=16000)
    sp.add_argument("--seconds", type=float, default=4.0,
                    help="fixed analysis window (see classical_main)")
    sp.add_argument("--features", default=",".join(("mfcc", "lfcc", "cqcc", "gtcc", "wpt", "formants")))
    sp.add_argument("--components", default="10,20,30,40")
    sp.add_argument("--extension", default=".flac")
    sp.add_argument("--cache-dir", default=None)
    sp.add_argument("--seed", type=int, default=42)
    device_flag(sp)
    sp.set_defaults(fn=cmd_classical, report_launches=True)
    return p


def main(argv: list[str] | None = None) -> int:
    """Run the chosen command; after a command that sets ``report_launches``
    returns 0, print the process's kernel launch counts
    (``ops.launch_counts``) as one JSON line on stderr."""
    args = build_parser().parse_args(argv)
    rc = args.fn(args)
    if rc == 0 and getattr(args, "report_launches", False):
        from audioanalysisdetector_tpu_torch.ops import launch_counts

        print(json.dumps({"kernel_launches": launch_counts()}), file=sys.stderr)
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
