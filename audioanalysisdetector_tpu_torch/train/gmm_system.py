"""GMM-UBM system orchestration: UBM fit + per-class MAP + persistence (PyTorch).

Counterpart of the JAX package's ``train/gmm_system.py`` (the reference's
``gmm_model`` / ``load_gmm_models`` / ``eval_model``,
reference/ASV_dl_func.py:1132-1170, :1467-1515): the GMM arm's frame
transform; ``train_gmm_system``, which fits a diagonal UBM by EM on all
training frames and MAP-adapts genuine (label 0) and spoof (label 1)
models off one uploaded frame buffer; the loaders of a model dir either
package wrote (``ubm.npz``, ``gmm_genuine.npz``, ``gmm_df.npz``,
``feature_transform.json``, ``best_model.msgpack``); and ``eval_model``
over it, which trains the GMMs when the dir has none.

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
from audioanalysisdetector_tpu_torch.models.gmm import (
    DiagGMM,
    fit_em,
    from_numpy,
    map_adapt,
    map_adapt_chunked,
    to_numpy,
)


def _stack_frames(seqs: np.ndarray) -> np.ndarray:
    """(N, T, F) sequences -> (N*T, F) frames (vstack of feature cells)."""
    seqs = np.asarray(seqs)
    return seqs.reshape(-1, seqs.shape[-1])


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


@torch.no_grad()
def train_gmm_system(
    train_seqs: np.ndarray,
    labels: np.ndarray,
    *,
    n_components: int = 128,
    max_iter: int = 100,
    relevance_factor: float = 10.0,
    adapt_mode: str = "means",
    var_floor_rel: float = 1e-3,
    deltas: bool = False,
    cmvn: bool = False,
    model_dir: str = "GMM-BiLSTM",
    seed: int = 42,
    verbose: bool = False,
    device: str | torch.device = "cuda",
) -> tuple[DiagGMM, DiagGMM, DiagGMM]:
    """Returns (ubm, gmm_genuine, gmm_spoof) on ``device`` and persists them
    in model_dir as the JAX package does.

    ``adapt_mode``: ``"means"`` (default), Reynolds-style means-only MAP;
    ``"full"``, the reference's means+variances+weights update
    (reference/ASV_dl_func.py:1172-1197), which the JAX package measured to
    destabilize the LLR. ``var_floor_rel`` guards the UBM EM against
    variance collapse. ``deltas``/``cmvn`` select the GMM frame transform
    (:func:`make_gmm_feature_fn`), which runs on the device over the
    uploaded ``(N, T, F)`` sequences and is written to
    ``feature_transform.json``; score with the same transform.

    The frames are uploaded once: EM and both MAP adaptations share the
    buffer, the class split is a 0/1 frame-weight mask. MAP takes the
    chunked accumulator when the (N, K) responsibilities would pass 2 GiB,
    the JAX package's rule.
    """
    if adapt_mode not in ("means", "full"):
        raise ValueError(f"adapt_mode must be 'means' or 'full', got {adapt_mode!r}")
    os.makedirs(model_dir, exist_ok=True)
    labels = np.asarray(labels)

    feature_fn = make_gmm_feature_fn(deltas=deltas, cmvn=cmvn)
    if feature_fn is not None:
        seqs = torch.from_numpy(np.ascontiguousarray(np.asarray(train_seqs), dtype=np.float32)).to(device)
        xd = feature_fn(seqs).reshape(seqs.shape[0] * seqs.shape[1], -1)
    else:
        xd = torch.from_numpy(np.ascontiguousarray(_stack_frames(train_seqs), dtype=np.float32)).to(device)
    n_frames = xd.shape[0]
    frames_per_seq = int(np.asarray(train_seqs).shape[1])
    frame_labels = np.repeat(labels, frames_per_seq)

    t0 = time.time()
    ubm = fit_em(xd, n_components, max_iter=max_iter, seed=seed, var_floor_rel=var_floor_rel, verbose=verbose)
    if verbose:
        print(f"UBM EM done in {time.time() - t0:.2f}s on {n_frames} frames")

    full = adapt_mode == "full"
    t0 = time.time()
    adapt = map_adapt if n_frames * n_components * 4 <= (2 << 30) else map_adapt_chunked

    def adapt_to(label: int) -> DiagGMM:
        w = torch.from_numpy((frame_labels == label).astype(np.float32)).to(xd.device)
        return adapt(ubm, xd, relevance_factor=relevance_factor, frame_weights=w,
                     adapt_vars=full, adapt_weights=full)

    gmm_genuine, gmm_spoof = adapt_to(0), adapt_to(1)
    if verbose:
        print(f"MAP adaptation done in {time.time() - t0:.2f}s")

    for name, g in (("ubm", ubm), ("gmm_genuine", gmm_genuine), ("gmm_df", gmm_spoof)):
        np.savez(os.path.join(model_dir, f"{name}.npz"), **to_numpy(g))
    # the transform beside the models: GMMs trained on CMVN/delta frames and
    # scored on raw frames give wrong LLRs with no shape error
    with open(os.path.join(model_dir, "feature_transform.json"), "w") as f:
        json.dump({"deltas": bool(deltas), "cmvn": bool(cmvn)}, f)
    return ubm, gmm_genuine, gmm_spoof


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
    their frame transform if present (else train them from the train split
    with ``n_components`` and the identity transform), then run the batched
    fused scorer over the test set on ``device``. Returns (y_true, y_pred,
    metrics)."""
    from audioanalysisdetector_tpu_torch.score.fused import eval_fused, make_fused_scorer

    have_saved = use_saved_models and all(
        os.path.exists(os.path.join(model_dir, f"{n}.npz")) for n in ("ubm", "gmm_genuine", "gmm_df")
    )
    if have_saved:
        _, gmm_genuine, gmm_spoof = load_gmm_models(model_dir, device=device)
        feature_fn = load_gmm_feature_fn(model_dir)
    else:
        if train_seqs is None:
            raise ValueError("train data required to train GMMs when none are saved")
        _, gmm_genuine, gmm_spoof = train_gmm_system(
            train_seqs, train_labels, n_components=n_components, model_dir=model_dir,
            verbose=verbose, device=device,
        )
        feature_fn = None
    t0 = time.time()
    scorer = make_fused_scorer(model, gmm_genuine, gmm_spoof, gmm_feature_fn=feature_fn)
    y_true, y_pred, metrics = eval_fused(scorer, test_seqs, test_labels, batch_size=batch_size, device=device)
    if verbose:
        print(f"evaluation finished in {time.time() - t0:.2f}s: {metrics}")
    return y_true, y_pred, metrics
