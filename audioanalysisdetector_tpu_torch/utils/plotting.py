"""Plotting helpers — per-label feature histograms (EDA role), on row lists.

Counterpart of the JAX package's ``utils/plotting.py`` (the reference's
``plot_coeff_histograms_by_label_separately``, reference/train_fun.py:197-223,
and the EDA notebook's histogram cells): PNGs of the same names, without
pandas. Without matplotlib the plots are skipped with one line on stderr
and no file is written.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from audioanalysisdetector_tpu_torch.data.balance import is_null


def plot_coeff_histograms_by_label(
    rows: list[dict],
    coeff_col: str,
    *,
    label_col: str = "label",
    out_dir: str = "eda_plots",
    bins: int = 10,
    max_coeffs: int | None = None,
) -> list[str]:
    """One histogram PNG per coefficient (``{coeff_col}_{i}.png``, i from 1),
    classes overlaid in order of first appearance; returns the paths."""
    try:
        import matplotlib
    except ImportError:
        print(f"matplotlib is not installed: no {coeff_col} histograms in {out_dir}", file=sys.stderr)
        return []

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    clean = [r for r in rows if not is_null(r[coeff_col])]
    if not clean:
        print(f"no data for feature {coeff_col}")
        return []
    os.makedirs(out_dir, exist_ok=True)
    n_coeffs = len(np.ravel(clean[0][coeff_col]))
    if max_coeffs:
        n_coeffs = min(n_coeffs, max_coeffs)
    values = np.stack([np.ravel(r[coeff_col])[:n_coeffs] for r in clean])
    labels = np.array([r[label_col] for r in clean])
    paths = []
    for i in range(n_coeffs):
        fig, ax = plt.subplots(figsize=(6, 4))
        for label in dict.fromkeys(labels.tolist()):  # pd.unique: order of first appearance
            subset = values[labels == label, i]
            ax.hist(subset, bins=bins, alpha=0.6, label=str(label), edgecolor="black")
        ax.set_title(f"{coeff_col}_{i + 1}")
        ax.set_xlabel("value")
        ax.set_ylabel("count")
        ax.legend()
        fig.tight_layout()
        path = os.path.join(out_dir, f"{coeff_col}_{i + 1}.png")
        fig.savefig(path, dpi=80)
        plt.close(fig)
        paths.append(path)
    return paths
