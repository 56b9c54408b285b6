"""Shape utilities over feature-cell row lists.

Counterpart of the JAX package's ``data/shape_utils.py``
``prepare_data_gmm_bilstm`` (the reference's ``prepare_data_GMM_BiLSTM``,
reference/ASV_dl_func.py:1761-1766: drop null cells, then time-major-ize
CQCC), without pandas. ``to_array_safe`` and ``build_X_from_df`` (the
classical path's design matrix) wait for ROADMAP Queue 1 step 12.
"""

from __future__ import annotations

import numpy as np

from audioanalysisdetector_tpu_torch.data.balance import filtr_nan


def prepare_data_gmm_bilstm(rows: list[dict], col_name: str = "cqcc") -> list[dict]:
    """Drop null feature cells, transpose each CQCC cell to time-major."""
    return [{**r, col_name: np.swapaxes(np.asarray(r[col_name]), -1, -2)} for r in filtr_nan(rows, col_name)]
