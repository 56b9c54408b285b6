"""Classification metrics of sklearn's ``metrics/_classification.py``, in numpy.

``accuracy_score``; binary ``f1_score`` (``pos_label=1``); and
``classification_report(..., output_dict=True)``: the per-label,
``"accuracy"``, ``"macro avg"`` and ``"weighted avg"`` entries. Where a
label is never predicted (or never true), its precision (recall, F1) is 0,
sklearn's ``zero_division="warn"`` result, without the warning.
"""

from __future__ import annotations

import numpy as np

from audioanalysisdetector_tpu_torch.ml._base import labels_of


def accuracy_score(y_true, y_pred) -> float:
    return float(np.average(labels_of(y_true) == labels_of(y_pred)))


def _divide(num: np.ndarray, den: np.ndarray) -> np.ndarray:
    """``_prf_divide`` with ``zero_division`` 0."""
    den = np.asarray(den, dtype=np.float64)
    mask = den == 0.0
    out = np.asarray(num, dtype=np.float64) / np.where(mask, 1.0, den)
    out[mask] = 0.0
    return out


def _prf(y_true: np.ndarray, y_pred: np.ndarray, labels) -> tuple[np.ndarray, ...]:
    """Per-label precision, recall, F1 and support."""
    tp = np.array([np.sum((y_true == lb) & (y_pred == lb)) for lb in labels])
    pred_sum = np.array([np.sum(y_pred == lb) for lb in labels])
    true_sum = np.array([np.sum(y_true == lb) for lb in labels])
    precision = _divide(tp, pred_sum)
    recall = _divide(tp, true_sum)
    f1 = _divide(2 * tp.astype(np.float64), true_sum.astype(np.float64) + pred_sum.astype(np.float64))
    return precision, recall, f1, true_sum


def f1_score(y_true, y_pred, *, pos_label=1) -> float:
    _, _, f1, _ = _prf(labels_of(y_true), labels_of(y_pred), [pos_label])
    return float(f1[0])


def classification_report(y_true, y_pred, *, output_dict: bool = True) -> dict:
    """The report over the sorted union of the labels, as sklearn's
    ``output_dict=True`` dict (the only form the port gives)."""
    if not output_dict:
        raise ValueError("the port's classification_report gives the dict form only (output_dict=True)")
    y_true, y_pred = labels_of(y_true), labels_of(y_pred)
    labels = np.unique(np.concatenate([y_true, y_pred]))
    p, r, f, s = _prf(y_true, y_pred, labels)
    report: dict = {}
    for k, lb in enumerate(labels):
        report[str(lb)] = {"precision": float(p[k]), "recall": float(r[k]), "f1-score": float(f[k]),
                           "support": float(s[k])}
    report["accuracy"] = accuracy_score(y_true, y_pred)
    total = float(s.sum())
    report["macro avg"] = {"precision": float(np.average(p)), "recall": float(np.average(r)),
                           "f1-score": float(np.average(f)), "support": total}
    report["weighted avg"] = {"precision": float(np.average(p, weights=s)), "recall": float(np.average(r, weights=s)),
                              "f1-score": float(np.average(f, weights=s)), "support": total}
    return report
