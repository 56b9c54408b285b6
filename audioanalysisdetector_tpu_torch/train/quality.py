"""EER-tracking surrogate evaluation: the quality trend line (PyTorch).

Counterpart of the JAX package's ``train/quality.py``. The quality north
star (ASVspoof-LA EER within 0.1% of the reference's 0.2565, BASELINE.md)
cannot be validated without ASVspoof audio, so rounds are compared on a
deterministic synthetic surrogate: the ``data.synthetic`` corpus
(speech-like bonafide vs three vocoder-artifact spoof tiers) run through the
reference's full flagship recipe via the port's ``train-asvspoof`` CLI:
metadata ingestion, in-repo FLAC decode, 2-s chunking, CQCC, balancing,
scaling, BiLSTM training, GMM-UBM + MAP, fused scoring
(ASV_deep_learning.ipynb cells 22-25), on ``device``.

The recipes, seed pairs and corpus are the JAX package's, so the port's
numbers compare with its ``QUALITY_r05.json``. Run the multi-seed lane on
the card with
``python -m audioanalysisdetector_tpu_torch.train.quality <workdir> --out <json>``.
"""

from __future__ import annotations

import argparse
import io
import json
import os
from contextlib import redirect_stdout

# frozen recipes, the JAX package's — change ONLY with a version bump, or
# round-over-round numbers stop being comparable (the history of each
# version is in the JAX package's train/quality.py).
RECIPE = dict(
    version=4,
    train=dict(n_bonafide=90, n_spoof_per_tier=30, seconds=4.5, seed=0),
    eval=dict(n_bonafide=120, n_spoof_per_tier=40, seconds=4.5, seed=1),
    epochs=60, hidden=64, gmm_components=64, batch_size=16, lr=3e-4,
    gmm_deltas=True, calibrate_llr=True, fusion_weight="auto",
)

RECIPE_V5 = dict(
    version=5,
    train=dict(
        n_bonafide=180, n_spoof_per_tier=60, seconds=4.5, seed=0,
        channel="varied",
    ),
    eval=dict(
        n_bonafide=480, n_spoof_per_tier=160, seconds=4.5, seed=1,
        channel="varied",
    ),
    epochs=40, hidden=64, gmm_components=128, batch_size=16, lr=3e-4,
    gmm_deltas=False, gmm_cmvn=True, calibrate_llr=False, fusion_weight=0.5,
)

RECIPES = {4: RECIPE, 5: RECIPE_V5}

# disjoint (train, eval) seed pairs for the robustness lane — (0, 1) is
# also the frozen per-round trend lane, kept first for continuity
SEED_PAIRS = ((0, 1), (2, 3), (4, 5), (6, 7), (8, 9))


def build_cqcc_arrays(
    metadata: str,
    audio_dirs,
    *,
    name: str,
    sr: int = 16000,
    sample_size: int | None = None,
    extension: str = ".flac",
    rescue_dir: str | None = None,
    seed: int = 0,
    balance: bool = False,
    return_attack: bool = False,
    augment: bool = False,
    device: str = "cuda",
):
    """Metadata + audio folders -> (x (N, T, 19) float32, y (N,) int) via the
    flagship CQCC path (ASV_deep_learning.ipynb cells 22-24): 2-s chunking,
    batched CQCC extraction on ``device``, NaN filtering, time-major
    transpose, optional train-split upsampling.

    ``return_attack=True`` appends the per-chunk attack-system ids
    (metadata ``attack_id`` column, '-'/'bonafide' for genuine speech) for
    per-tier EER. ``augment=True`` (the reference's row-expansion policy)
    waits for ROADMAP Queue 1 step 11 and raises."""
    import numpy as np

    from audioanalysisdetector_tpu_torch.data.balance import balance_upsample
    from audioanalysisdetector_tpu_torch.data.dataset import prepare_dataframe
    from audioanalysisdetector_tpu_torch.data.pipeline import extract_features
    from audioanalysisdetector_tpu_torch.data.shape_utils import prepare_data_gmm_bilstm

    if augment:
        raise NotImplementedError(
            "augment=True: augmentation is not ported to audioanalysisdetector_tpu_torch yet "
            "(ROADMAP Queue 1 step 11)"
        )
    all_data = {name: {"metadata": metadata, "flac": list(audio_dirs)}}
    rows = prepare_dataframe(
        all_data, balance=False, sample_size=sample_size,
        extension=extension, rescue_dir=rescue_dir,
    )
    if not rows:
        raise SystemExit(f"no usable utterances from {metadata}")
    rows = extract_features(rows, ["cqcc"], sr=sr, seed=seed, device=device)
    rows = prepare_data_gmm_bilstm(rows)  # filtr_nan + time-major transpose
    for r in rows:
        r["label_num"] = int(str(r["label"]).lower() == "spoof")
    if balance:
        rows = balance_upsample(rows, seed=seed)
    x = np.stack([np.asarray(r["cqcc"], np.float32) for r in rows])
    y = np.asarray([r["label_num"] for r in rows])
    if return_attack:
        return x, y, np.asarray([str(r.get("attack_id", "-")) for r in rows], dtype=object)
    return x, y


def run_surrogate_quality(workdir: str, *, recipe: dict | None = None, device: str = "cuda") -> dict:
    """Generate the surrogate corpus and run the flagship recipe end to end
    on ``device``.

    Returns {"bilstm": {...}, "gmm": {...}, "fused": {...}, "recipe": {...},
    ...}: the ``train-asvspoof`` JSON with the recipe."""
    from audioanalysisdetector_tpu_torch.cli.main import main
    from audioanalysisdetector_tpu_torch.data.synthetic import make_surrogate_corpus

    r = recipe or RECIPE
    if r.get("augment"):
        raise NotImplementedError(
            "recipe augment=True: augmentation is not ported to audioanalysisdetector_tpu_torch "
            "yet (ROADMAP Queue 1 step 11)"
        )
    tr_meta, tr_dir = make_surrogate_corpus(
        os.path.join(workdir, "train"), subset="train", **r["train"]
    )
    ev_meta, ev_dir = make_surrogate_corpus(
        os.path.join(workdir, "eval"), subset="eval", **r["eval"]
    )
    argv = [
        "train-asvspoof", tr_meta, ev_meta, "--audio-dir", tr_dir, ev_dir,
        "--epochs", str(r["epochs"]), "--hidden", str(r["hidden"]),
        "--gmm-components", str(r["gmm_components"]),
        "--batch-size", str(r["batch_size"]), "--lr", str(r["lr"]),
        "--run-dir", os.path.join(workdir, "run"), "--device", str(device),
    ]
    if r.get("fusion_weight") is not None:
        argv += ["--fusion-weight", str(r["fusion_weight"])]
    if r.get("calibrate_llr"):
        argv.append("--calibrate-llr")
    if r.get("gmm_deltas"):
        argv.append("--gmm-deltas")
    if r.get("gmm_cmvn"):
        argv.append("--gmm-cmvn")
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = main(argv)
    if rc != 0:
        raise RuntimeError(f"train-asvspoof failed rc={rc}:\n{buf.getvalue()}")
    metrics = json.loads(buf.getvalue().strip().splitlines()[-1])
    metrics["recipe"] = r
    return metrics


def run_multiseed_quality(
    workdir: str,
    *,
    recipe: dict | None = None,
    seed_pairs: tuple[tuple[int, int], ...] = SEED_PAIRS,
    precomputed: dict | None = None,
    device: str = "cuda",
) -> dict:
    """Robustness lane: the frozen recipe over several DISJOINT (train,
    eval) seed pairs, so a one-EER-step fused win cannot be an artifact of
    one seed pair. Returns per-seed fused/BiLSTM/GMM EER plus mean/std per
    arm and the fused-beats-BiLSTM win rate (ties count as wins: fusion's
    bar is "never worse than its best arm").

    ``precomputed`` maps a ``(train_seed, eval_seed)`` pair to an existing
    ``run_surrogate_quality`` result."""
    import numpy as np

    r = dict(recipe or RECIPE)
    per_seed = []
    for tr_seed, ev_seed in seed_pairs:
        if precomputed and (tr_seed, ev_seed) in precomputed:
            m = precomputed[(tr_seed, ev_seed)]
        else:
            ri = {**r, "train": {**r["train"], "seed": tr_seed},
                  "eval": {**r["eval"], "seed": ev_seed}}
            m = run_surrogate_quality(
                os.path.join(workdir, f"s{tr_seed}_{ev_seed}"), recipe=ri, device=device
            )
        per_seed.append({
            "seeds": [tr_seed, ev_seed],
            "bilstm_eer": m["bilstm"]["eer"],
            "gmm_eer": m["gmm"]["eer"],
            "fused_eer": m["fused"]["eer"],
            "fused_accuracy": m["fused"]["accuracy"],
            "bilstm_accuracy": m["bilstm"]["accuracy"],
            "fusion_weight": m["fused"].get("fusion_weight"),
            "per_tier_eer": m["fused"].get("per_tier_eer"),
        })
    agg = {}
    for arm in ("bilstm", "gmm", "fused"):
        vals = np.array([s[f"{arm}_eer"] for s in per_seed])
        agg[arm] = {"mean_eer": float(vals.mean()), "std_eer": float(vals.std())}
    wins = sum(s["fused_eer"] <= s["bilstm_eer"] + 1e-12 for s in per_seed)
    return {
        "recipe_version": r["version"],
        "n_seed_pairs": len(per_seed),
        "per_seed": per_seed,
        "aggregate": agg,
        "fused_win_rate": wins / len(per_seed),
    }


def main(argv: list[str] | None = None) -> int:
    """The multi-seed lane of one recipe on ``--device``; the result JSON
    goes to ``--out`` and, on one line, to stdout."""
    import time

    import torch

    p = argparse.ArgumentParser(description=main.__doc__)
    p.add_argument("workdir")
    p.add_argument("--recipe", type=int, choices=sorted(RECIPES), default=5)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    t0 = time.time()
    result = run_multiseed_quality(args.workdir, recipe=RECIPES[args.recipe], device=args.device)
    result["seconds"] = time.time() - t0
    result["device"] = (torch.cuda.get_device_name(0) if str(args.device).startswith("cuda") else str(args.device))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
