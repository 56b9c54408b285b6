"""GMM-UBM system, the load and evaluation side (PyTorch).

Counterpart of the JAX package's ``train/gmm_system.py`` (the reference's
``gmm_model`` / ``load_gmm_models`` / ``eval_model``,
reference/ASV_dl_func.py:1132-1170, :1467-1515): the GMM arm's frame
transform, the loaders of a model dir the JAX package's
``train_gmm_system`` and ``fit`` wrote (``ubm.npz``, ``gmm_genuine.npz``,
``gmm_df.npz``, ``feature_transform.json``, ``best_model.msgpack``), and
``eval_model`` over it. Training the GMMs (``train_gmm_system``, the
branch of ``eval_model`` that trains them) waits for ROADMAP Queue 1
step 8.

Known fault of the reference kept, as in the JAX package: ``sequence_cmvn``
ignores the padding mask (``ADVICE.md``).
"""

from __future__ import annotations

import glob
import json
import os
import time

import numpy as np
import torch

from audioanalysisdetector_tpu_torch.frontend.mfcc import cmvn, delta
from audioanalysisdetector_tpu_torch.models.gmm import DiagGMM, from_numpy


def add_sequence_deltas(seqs: torch.Tensor, *, width: int = 9) -> torch.Tensor:
    """(…, T, F) time-major sequences -> (…, T, 3F): append Δ and ΔΔ along
    the coefficient axis (Savitzky-Golay over time, librosa semantics)."""
    d1 = delta(seqs, width=width, order=1, axis=-2)
    d2 = delta(seqs, width=width, order=2, axis=-2)
    return torch.cat([seqs, d1, d2], dim=-1)


def sequence_cmvn(seqs: torch.Tensor, *, variance: bool = True) -> torch.Tensor:
    """(…, T, F) -> per-utterance cepstral mean (and variance) normalization
    over the TIME axis (unmasked: the flagship path feeds fixed-length
    chunks)."""
    return cmvn(seqs, axis=-2, variance=variance)


def make_gmm_feature_fn(*, deltas: bool = False, cmvn: bool = False):
    """Compose the GMM arm's frame transform; ``None`` for identity. Order
    is deltas-then-CMVN, as the JAX package's."""
    if not deltas and not cmvn:
        return None

    def fn(seqs: torch.Tensor) -> torch.Tensor:
        if deltas:
            seqs = add_sequence_deltas(seqs)
        if cmvn:
            seqs = sequence_cmvn(seqs)
        return seqs

    return fn


def load_gmm_models(model_dir: str, *, device: str | torch.device = "cuda") -> tuple[DiagGMM, DiagGMM, DiagGMM]:
    """(ubm, gmm_genuine, gmm_spoof) from the dir's npz files, on ``device``."""
    out = []
    for name in ("ubm", "gmm_genuine", "gmm_df"):
        with np.load(os.path.join(model_dir, f"{name}.npz")) as z:
            out.append(from_numpy({k: z[k] for k in z.files}, device=device))
    return tuple(out)


def load_gmm_feature_fn(model_dir: str):
    """Recompose the frame transform the saved GMMs were trained with
    (``feature_transform.json``); ``None`` for identity, also for model dirs
    written before the file existed (all trained on raw frames)."""
    path = os.path.join(model_dir, "feature_transform.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        d = json.load(f)
    return make_gmm_feature_fn(deltas=d.get("deltas", False), cmvn=d.get("cmvn", False))


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return tuple(tree.shape)


def load_bilstm_model(
    model_dir: str, hidden: int = 128, input_dim: int = 19, *, device: str | torch.device = "cuda"
):
    """The trained ``BiLSTMClassifier`` of ``model_dir`` (the first
    ``best_model.msgpack`` under it, a JAX ``fit()`` payload) in eval mode on
    ``device`` (the reference's ``load_bilstm_model``,
    reference/ASV_dl_func.py:1768-1773). A checkpoint of another hidden or
    input width fails here, naming both shapes, as in the JAX package."""
    from audioanalysisdetector_tpu_torch.convert import (
        flax_to_torch_bilstm_classifier,
        random_flax_bilstm_classifier,
    )
    from audioanalysisdetector_tpu_torch.models.bilstm_classifier import BiLSTMClassifier
    from audioanalysisdetector_tpu_torch.train.checkpoint import load_payload

    candidates = sorted(glob.glob(os.path.join(model_dir, "**", "best_model.msgpack"), recursive=True))
    if not candidates:
        raise FileNotFoundError(f"no best_model.msgpack under {model_dir}")
    payload = load_payload(candidates[0])
    ref_shapes = _shapes(random_flax_bilstm_classifier(0, hidden, input_dim)["params"])
    got_shapes = _shapes(payload["params"])
    if ref_shapes != got_shapes:
        raise ValueError(
            f"checkpoint {candidates[0]} does not match "
            f"BiLSTMClassifier(hidden={hidden}, input_dim={input_dim}): "
            f"expected {ref_shapes}, got {got_shapes}"
        )
    model = BiLSTMClassifier(hidden=hidden, input_dim=input_dim)
    model.load_state_dict(flax_to_torch_bilstm_classifier({"params": payload["params"]}))
    return model.to(device).eval()


def eval_model(
    model: torch.nn.Module,
    train_seqs: np.ndarray | None,
    train_labels: np.ndarray | None,
    test_seqs: np.ndarray,
    test_labels: np.ndarray,
    *,
    model_dir: str = "GMM-BiLSTM",
    use_saved_models: bool = True,
    n_components: int = 128,
    batch_size: int = 512,
    verbose: bool = True,
    device: str | torch.device = "cuda",
):
    """The reference's ``eval_model`` orchestration
    (reference/ASV_dl_func.py:1467-1515): load the saved per-class GMMs and
    their frame transform, then run the batched fused scorer over the test
    set on ``device``. Returns (y_true, y_pred, metrics)."""
    from audioanalysisdetector_tpu_torch.score.fused import eval_fused, make_fused_scorer

    have_saved = use_saved_models and all(
        os.path.exists(os.path.join(model_dir, f"{n}.npz")) for n in ("ubm", "gmm_genuine", "gmm_df")
    )
    if not have_saved:
        raise NotImplementedError(
            "training the GMMs (train_gmm_system: EM, k-means seeding, MAP) is not ported "
            "yet (ROADMAP Queue 1 step 8); pass a model_dir with saved ubm/gmm_genuine/gmm_df.npz"
        )
    _, gmm_genuine, gmm_spoof = load_gmm_models(model_dir, device=device)
    feature_fn = load_gmm_feature_fn(model_dir)
    t0 = time.time()
    scorer = make_fused_scorer(model, gmm_genuine, gmm_spoof, gmm_feature_fn=feature_fn)
    y_true, y_pred, metrics = eval_fused(scorer, test_seqs, test_labels, batch_size=batch_size, device=device)
    if verbose:
        print(f"evaluation finished in {time.time() - t0:.2f}s: {metrics}")
    return y_true, y_pred, metrics
