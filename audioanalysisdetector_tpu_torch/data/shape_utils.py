"""Shape utilities over feature-cell row lists.

Counterpart of the JAX package's ``data/shape_utils.py``, without pandas:
``to_array_safe`` / ``build_X_from_df`` (the reference's ``_to_array_safe``
/ ``build_X_from_df``, reference/ASV_dl_func.py:1519-1559: flatten ragged
feature cells and zero-pad them into a design matrix) and
``prepare_data_gmm_bilstm`` (``prepare_data_GMM_BiLSTM``, :1761-1766: drop
null cells, then time-major-ize CQCC). A table is a list of row dicts.
"""

from __future__ import annotations

import numpy as np

from audioanalysisdetector_tpu_torch.data.balance import filtr_nan


def to_array_safe(x) -> np.ndarray:
    """Any cell value -> 1-D float array ([] for None)."""
    if x is None:
        return np.array([])
    try:
        arr = np.asarray(x)
    except Exception:
        # a ragged nested list: numpy refuses it; flatten recursively
        return np.asarray(list(_flatten(x)), dtype=float)
    if arr.dtype == object:
        # ragged nested cells that numpy kept as objects: ravel would keep
        # the sub-lists as elements, so flatten recursively instead
        return np.asarray(list(_flatten(x)), dtype=float)
    return np.ravel(arr)


def _flatten(v):
    if isinstance(v, (list, tuple, np.ndarray)):
        for item in v:
            yield from _flatten(item)
    else:
        yield float(v)


def build_X_from_df(rows: list[dict], feature_cols: list[str]) -> np.ndarray:
    """Concat-flatten the named feature cells of each row; zero-pad ragged rows."""
    out = []
    for row in rows:
        parts = [p for p in (to_array_safe(row[c]) for c in feature_cols) if p.size > 0]
        out.append(np.hstack(parts) if parts else np.array([]))
    lengths = {r.size for r in out}
    if len(lengths) > 1:
        X = np.zeros((len(out), max(lengths)), dtype=float)
        for i, r in enumerate(out):
            X[i, : r.size] = r
        return X
    return np.vstack(out) if out else np.empty((0, 0))


def prepare_data_gmm_bilstm(rows: list[dict], col_name: str = "cqcc") -> list[dict]:
    """Drop null feature cells, transpose each CQCC cell to time-major."""
    return [{**r, col_name: np.swapaxes(np.asarray(r[col_name]), -1, -2)} for r in filtr_nan(rows, col_name)]
