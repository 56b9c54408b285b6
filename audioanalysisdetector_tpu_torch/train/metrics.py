"""Evaluation metrics: accuracy, F1, and the reference's EER formula (numpy).

Counterpart of the host half of the JAX package's ``train/metrics.py``. The
reference computes EER from sklearn's ROC as ``fpr[argmin |fnr - fpr|]``
(reference/ASV_dl_func.py:860-869, :1503-1506), the *unbalanced* variant
that picks the FPR at the crossover threshold; kept exactly. ``eer_tensor``
is the on-device counterpart of the JAX package's ``eer_jnp``.
"""

from __future__ import annotations

import numpy as np
import torch


def roc_curve_np(y_true: np.ndarray, scores: np.ndarray, *, drop_intermediate: bool = True):
    """(fpr, tpr, thresholds) with sklearn's conventions.

    Thresholds descend; each unique score is a threshold; a leading
    ``+inf``-like point (sklearn uses max+1) pins (fpr, tpr) = (0, 0).
    ``drop_intermediate`` removes suboptimal collinear interior points —
    sklearn's DEFAULT, and part of the reference's EER contract.
    """
    y_true = np.asarray(y_true).astype(bool)
    scores = np.asarray(scores, dtype=np.float64)
    order = np.argsort(-scores, kind="mergesort")
    y_sorted = y_true[order]
    s_sorted = scores[order]
    distinct = np.where(np.diff(s_sorted))[0]
    idx = np.r_[distinct, y_true.size - 1]
    tps = np.cumsum(y_sorted)[idx]
    fps = 1 + idx - tps
    if drop_intermediate and len(fps) > 2:
        keep = np.where(np.r_[True, np.logical_or(np.diff(fps, 2), np.diff(tps, 2)), True])[0]
        fps, tps, idx = fps[keep], tps[keep], idx[keep]
    thresholds = np.r_[s_sorted[0] + 1, s_sorted[idx]]
    tps = np.r_[0, tps]
    fps = np.r_[0, fps]
    p = max(tps[-1], 1)
    n = max(fps[-1], 1)
    return fps / n, tps / p, thresholds


def eer(y_true, scores) -> float:
    """The reference's EER: ``fpr[argmin |fnr - fpr|]``. Raises on
    single-class labels (the reference's sklearn path yields NaN there)."""
    y = np.asarray(y_true).astype(bool)
    if y.all() or not y.any():
        raise ValueError("eer: y_true contains a single class")
    fpr, tpr, _ = roc_curve_np(y_true, scores)
    fnr = 1.0 - tpr
    return float(fpr[np.nanargmin(np.abs(fnr - fpr))])


def eer_threshold(y_true, scores) -> float:
    fpr, tpr, thr = roc_curve_np(y_true, scores)
    fnr = 1.0 - tpr
    return float(thr[np.nanargmin(np.abs(fnr - fpr))])


def accuracy(y_true, y_pred) -> float:
    return float(np.mean(np.asarray(y_true) == np.asarray(y_pred)))


def f1_binary(y_true, y_pred, *, pos_label: int = 1) -> float:
    y_true = np.asarray(y_true) == pos_label
    y_pred = np.asarray(y_pred) == pos_label
    tp = np.sum(y_true & y_pred)
    fp = np.sum(~y_true & y_pred)
    fn = np.sum(y_true & ~y_pred)
    denom = 2 * tp + fp + fn
    return float(2 * tp / denom) if denom else 0.0


def f1_macro(y_true, y_pred) -> float:
    labels = np.unique(np.concatenate([np.asarray(y_true), np.asarray(y_pred)]))
    return float(np.mean([f1_binary(y_true, y_pred, pos_label=int(l)) for l in labels]))


def model_result_metrics(y_true, y_pred, scores=None) -> dict[str, float]:
    """accuracy / F1 / EER bundle (reference/ASV_dl_func.py:832-869)."""
    out = {"accuracy": accuracy(y_true, y_pred), "f1": f1_binary(y_true, y_pred)}
    if scores is not None:
        out["eer"] = eer(y_true, scores)
    return out


def eer_tensor(y_true: torch.Tensor, scores: torch.Tensor) -> torch.Tensor:
    """Fixed-size EER on the scores' device (every score a threshold): the
    JAX package's ``eer_jnp``, an approximation of the host ``eer`` for
    in-loop monitoring (float32 scores, no drop-intermediate thinning).
    FPR and FNR come from an (N, N) comparison; a 0-d tensor."""
    y = y_true.to(torch.bool)
    s = scores.to(torch.float32)
    # thresholds descending, so argmin's first-occurrence tie rule matches
    # the host's candidate order; the virtual (fpr, fnr) = (0, 1) point
    # mirrors the host curve's leading max+1 row
    thr = torch.sort(s, descending=True).values
    ge = s[None, :] >= thr[:, None]  # [t, i]
    p = y.sum().clamp_min(1)
    n = (~y).sum().clamp_min(1)
    tpr = (ge & y[None, :]).sum(dim=1) / p
    fpr = (ge & ~y[None, :]).sum(dim=1) / n
    fpr = torch.cat([fpr.new_zeros(1), fpr])
    fnr = torch.cat([tpr.new_ones(1), 1.0 - tpr])
    return fpr[torch.argmin((fnr - fpr).abs())]
