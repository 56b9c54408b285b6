"""Class balancing over row lists.

Counterpart of the JAX package's ``data/balance.py``, without pandas: a
table is a list of row dicts, and the draws are the ones its pandas calls
make, so both packages pick the same rows in the same order.

- ``balance_upsample``: minority upsampled with replacement to match the
  majority (reference ``balance_func``, reference/ASV_dl_func.py:1074-1088),
  ``default_rng(seed).integers``.
- ``balance_downsample``: majority downsampled without replacement, as
  pandas' ``sample(n, random_state=seed)`` draws it:
  ``RandomState(seed).choice(len, n, replace=False)``. (The reference's
  ``downsampled_dataset`` compares DataFrames with ``<``,
  reference/ASV_dl_func.py:132, a crash; this is what it evidently meant.)
- ``filtr_nan``: drop rows whose feature cell is null.

``add_data_augmentation`` (the reference's 0.8 / 0.5 oversampling policy)
waits for ROADMAP Queue 1 step 11, with the augmentations.
"""

from __future__ import annotations

import numpy as np


def is_null(value) -> bool:
    """pandas' ``isnull`` for one cell: None or a float NaN."""
    return value is None or (isinstance(value, float) and value != value)


def sample_rows(rows: list[dict], n: int, seed: int) -> list[dict]:
    """``DataFrame.sample(n, random_state=seed)``: n rows without
    replacement, in the order drawn."""
    return [rows[i] for i in np.random.RandomState(seed).choice(len(rows), n, replace=False)]


def _resample_with_replacement(rows: list[dict], n: int, seed: int) -> list[dict]:
    return [rows[i] for i in np.random.default_rng(seed).integers(0, len(rows), n)]


def _split(rows: list[dict], col_name: str) -> tuple[list[dict], list[dict]]:
    return [r for r in rows if r[col_name] == 0], [r for r in rows if r[col_name] == 1]


def balance_upsample(rows: list[dict], col_name: str = "label_num", *, seed: int = 42) -> list[dict]:
    df0, df1 = _split(rows, col_name)
    if not df0 or not df1:
        # e.g. every row of one class dropped by decode failure + filtr_nan
        raise ValueError(f"balance_upsample: class {'0' if not df0 else '1'} has no rows")
    if len(df0) > len(df1):
        df1 = _resample_with_replacement(df1, len(df0), seed)
    else:
        df0 = _resample_with_replacement(df0, len(df1), seed)
    return df0 + df1


def balance_downsample(rows: list[dict], col_name: str = "label_num", *, seed: int = 42) -> list[dict]:
    df0, df1 = _split(rows, col_name)
    minority, majority = (df0, df1) if len(df0) < len(df1) else (df1, df0)
    return sample_rows(majority, len(minority), seed) + minority


def filtr_nan(rows: list[dict], col_name: str = "cqcc") -> list[dict]:
    """Drop rows whose feature cell is null (reference/ASV_dl_func.py:1065-1071)."""
    out = [r for r in rows if not is_null(r[col_name])]
    if len(out) < len(rows):
        print(f"dropped {len(rows) - len(out)} rows with empty {col_name}")
    return out
