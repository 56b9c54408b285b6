"""Batched fused GMM ⊕ BiLSTM spoof scorer (PyTorch).

Counterpart of the JAX package's ``score/fused.py``. The reference scores
one utterance at a time with a host round-trip per sample (``fused_score``,
reference/ASV_dl_func.py:1448-1462); here a whole batch is scored on the
device:

  score = 0.5 * softmax(BiLSTM(x))[:, spoof] + 0.5 * sigmoid(GMM LLR_spoof)

with the reference's semantics: non-padded frames recovered by the
``row.sum(axis=-1) != 0`` mask, empty sequences scoring 0.5, decision
threshold 0.5, 0.5/0.5 weights (reference/ASV_dl_func.py:1486-1491).

The JAX package's one documented deviation is kept: both halves are fused
in spoof polarity (``LLR_spoof = ll_spoof - ll_genuine``), where the
reference's literal formula fuses a genuine-polarity GMM term
(reference/ASV_dl_func.py:1459-1462).

The BiLSTM arm is a ``torch.nn.Module`` carrying its weights, where the JAX
functions take ``(bilstm_apply, variables)``. The batch scorers run under
``torch.inference_mode()`` with TF32 off (``ieee_fp32``).
"""

from __future__ import annotations

from functools import partial
from typing import Callable

import numpy as np
import torch

from audioanalysisdetector_tpu_torch.models.gmm import DiagGMM, masked_llr
from audioanalysisdetector_tpu_torch.train import metrics as M


def ieee_fp32() -> None:
    """Full fp32 for the process: ``torch.backends.cuda.matmul.allow_tf32 =
    False`` and ``torch.backends.cudnn.allow_tf32 = False`` (the second
    defaults to True and would run convolutions and the cuDNN LSTM in TF32).
    Every scorer of the port sets it, so the card's scores stay with the
    CPU's."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def padding_mask(x: torch.Tensor) -> torch.Tensor:
    """Valid-frame mask: frame is real iff its coefficient sum is non-zero
    (the reference's pad-recovery rule, reference/ASV_dl_func.py:1486)."""
    return torch.sum(x, dim=-1) != 0.0


def arm_scores(
    model: torch.nn.Module,
    gmm_genuine: DiagGMM,
    gmm_spoof: DiagGMM,
    x: torch.Tensor,
    *,
    gmm_feature_fn: Callable | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Both arms of the fusion for a batch: x (B, T, F) ->
    (bilstm_prob (B,), llr_spoof (B,), empty (B,) bool).

    ``gmm_feature_fn`` optionally transforms the GMM arm's frames; the
    padding mask comes from the RAW x and the BiLSTM sees the raw features.
    """
    bilstm_prob = torch.softmax(model(x), dim=-1)[:, 1]
    mask = padding_mask(x)
    gx = gmm_feature_fn(x) if gmm_feature_fn is not None else x
    llr_spoof = masked_llr(gx, mask, gmm_spoof, gmm_genuine)
    empty = torch.sum(mask, dim=-1) == 0
    return bilstm_prob, llr_spoof, empty


def fused_scores(
    model: torch.nn.Module,
    gmm_genuine: DiagGMM,
    gmm_spoof: DiagGMM,
    x: torch.Tensor,
    *,
    weight: float = 0.5,
    llr_scale: float = 1.0,
    llr_bias: float = 0.0,
    gmm_feature_fn: Callable | None = None,
) -> torch.Tensor:
    """Fused spoof probabilities for a batch: x (B, T, F) -> (B,).

    ``llr_scale``/``llr_bias`` optionally Platt-calibrate the GMM arm
    (``sigmoid(scale * LLR + bias)``; fit them with ``fit_llr_calibration``).
    The defaults are the reference's literal ``sigmoid(LLR)``.
    """
    bilstm_prob, llr_spoof, empty = arm_scores(
        model, gmm_genuine, gmm_spoof, x, gmm_feature_fn=gmm_feature_fn
    )
    gmm_prob = torch.sigmoid(llr_scale * llr_spoof + llr_bias)
    score = weight * bilstm_prob + (1.0 - weight) * gmm_prob
    return torch.where(empty, torch.full_like(score, 0.5), score)


def _scorer(fn: Callable, model: torch.nn.Module) -> Callable:
    ieee_fp32()
    model.eval()
    return torch.inference_mode()(fn)


def make_fused_scorer(
    model: torch.nn.Module,
    gmm_genuine: DiagGMM,
    gmm_spoof: DiagGMM,
    *,
    weight: float = 0.5,
    llr_scale: float = 1.0,
    llr_bias: float = 0.0,
    gmm_feature_fn: Callable | None = None,
) -> Callable:
    """Batch scorer ``(B, T, F) -> (B,)`` with everything closed over."""
    return _scorer(partial(
        fused_scores, model, gmm_genuine, gmm_spoof, weight=weight, llr_scale=llr_scale,
        llr_bias=llr_bias, gmm_feature_fn=gmm_feature_fn,
    ), model)


def make_arm_scorer(
    model: torch.nn.Module,
    gmm_genuine: DiagGMM,
    gmm_spoof: DiagGMM,
    *,
    gmm_feature_fn: Callable | None = None,
) -> Callable:
    """``(B, T, F) -> (bilstm_prob, llr, empty)`` batch scorer — per-arm
    diagnostics (GMM-alone EER, calibration fitting) in one pass."""
    return _scorer(partial(arm_scores, model, gmm_genuine, gmm_spoof, gmm_feature_fn=gmm_feature_fn), model)


def fit_llr_calibration(llrs: np.ndarray, y_true: np.ndarray, *, iters: int = 50) -> tuple[float, float]:
    """Platt scaling of the GMM arm: fit (scale, bias) of
    ``P(spoof) = sigmoid(scale * LLR + bias)`` by Newton-Raphson logistic
    regression on a train split (host-side; the problem is 2-parameter).
    """
    llrs = np.asarray(llrs, np.float64)
    y = np.asarray(y_true, np.float64)
    n = len(y)
    a, b = 1.0, 0.0
    for _ in range(iters):
        z = np.clip(a * llrs + b, -30.0, 30.0)
        p = 1.0 / (1.0 + np.exp(-z))
        g_a, g_b = np.sum((p - y) * llrs), np.sum(p - y)
        w = np.maximum(p * (1.0 - p), 1e-6)
        # N-scaled ridge keeps the Hessian well-conditioned when the LLRs
        # are (near-)constant
        ridge = 1e-4 * n
        h_aa = np.sum(w * llrs * llrs) + ridge
        h_bb = np.sum(w) + ridge
        h_ab = np.sum(w * llrs)
        det = h_aa * h_bb - h_ab * h_ab
        da = (h_bb * g_a - h_ab * g_b) / det
        db = (h_aa * g_b - h_ab * g_a) / det
        # trust region: cap the step so one bad Hessian cannot diverge it
        step = max(abs(da), abs(db))
        if step > 5.0:
            da, db = da * 5.0 / step, db * 5.0 / step
        a, b = a - da, b - db
        if step < 1e-10:
            break
    return float(a), float(b)


def fit_decision_threshold(scores: np.ndarray, y_true: np.ndarray) -> float:
    """Operating threshold at the EER point of a labeled split (host-side):
    the candidate minimizing |FPR - FNR| (ties toward lower total error),
    swept over midpoints between adjacent distinct scores. The reference's
    0.5 stays the default decision contract everywhere else."""
    s = np.asarray(scores, np.float64)
    y = np.asarray(y_true)
    neg, pos = s[y == 0], s[y == 1]
    if len(neg) == 0 or len(pos) == 0:
        return 0.5
    uniq = np.unique(s)
    cands = np.concatenate([[uniq[0] - 1.0], (uniq[:-1] + uniq[1:]) / 2.0, [uniq[-1] + 1.0]])
    fpr = (neg[None, :] > cands[:, None]).mean(axis=1)
    fnr = (pos[None, :] <= cands[:, None]).mean(axis=1)
    best = np.lexsort((fpr + fnr, np.abs(fpr - fnr)))[0]
    return float(cands[best])


def eval_fused(
    scorer: Callable,
    x: np.ndarray,
    y_true: np.ndarray,
    *,
    batch_size: int = 512,
    threshold: float = 0.5,
    device: str | torch.device = "cuda",
) -> tuple[np.ndarray, np.ndarray, dict[str, float]]:
    """Reference ``eval_model`` contract: (y_true, y_pred, {accuracy, f1, eer}).

    Each batch goes to ``device`` (the card unless the caller names
    another); the tail batch is padded by repeating its last row, so every
    call has the same shape, as in the JAX package.
    """
    n = len(y_true)
    scores = np.empty(n, dtype=np.float64)
    for start in range(0, n, batch_size):
        xb = x[start : start + batch_size]
        true = len(xb)
        if true < batch_size:
            xb = np.concatenate([xb, np.repeat(xb[-1:], batch_size - true, axis=0)])
        out = scorer(torch.as_tensor(np.ascontiguousarray(xb, np.float32)).to(device))
        scores[start : start + true] = out.cpu().numpy()[:true]
    y_pred = (scores > threshold).astype(np.int64)
    metrics = {
        "accuracy": M.accuracy(y_true, y_pred),
        "f1": M.f1_binary(y_true, y_pred),
        "eer": M.eer(y_true, scores),
    }
    return np.asarray(y_true), y_pred, metrics
