"""Windowed kernel-SHAP analogue for the GMM scorer (PyTorch).

Counterpart of the JAX package's ``xai/shap_gmm.py``, the same numpy
coalitions (``np.random.default_rng(seed)``) and solve; the coalitions are
scored as one batched call of the caller's ``score_fn`` on torch tensors
(the port's ``models/gmm.py``). The reference wraps ``shap.KernelExplainer`` around sliding time windows
(size 10, stride 5) of a (T, F) CQCC instance, scoring coalitions by
``sigmoid(LLR)`` with masked-out windows replaced by a background
substitution, then averages overlapping window attributions into a (T, F)
heatmap (reference/tets_xai.py:28-67). shap is not installed here; this is
a self-contained kernel-SHAP implementation with the standard Shapley
kernel weights and a weighted least-squares solve — coalition evaluation is
one batched device call.
"""

from __future__ import annotations

from math import comb
from typing import Callable

import numpy as np
import torch


def time_windows(T: int, *, size: int = 10, stride: int = 5) -> np.ndarray:
    starts = list(range(0, max(T - size, 0) + 1, stride))
    if not starts:
        starts = [0]
    # cover the tail: when (T - size) % stride != 0 the last strided window
    # stops short and the trailing frames would sit in NO window — kept at
    # their original value in every coalition and silently attributed zero
    last = max(T - size, 0)
    if starts[-1] != last:
        starts.append(last)
    return np.asarray([(s, min(s + size, T)) for s in starts])  # (M, 2)


def _shapley_kernel_weight(M: int, s: int) -> float:
    if s == 0 or s == M:
        return 1e6  # enforced endpoints (standard kernel-SHAP practice)
    return (M - 1) / (comb(M, s) * s * (M - s))


def gmm_shap(
    score_fn: Callable,
    instance: np.ndarray,
    *,
    window_size: int = 10,
    stride: int = 5,
    n_coalitions: int = 256,
    background: np.ndarray | None = None,
    seed: int = 0,
    device: str | torch.device = "cpu",
) -> np.ndarray:
    """Per-cell SHAP heatmap (T, F) for a single instance.

    ``score_fn``: batched (B, T, F) float32 tensor on ``device`` -> (B,)
    probability (sigmoid LLR). ``background``: substitution values (T, F);
    defaults to the per-feature time mean of the instance.
    """
    x = np.asarray(instance.detach().cpu() if isinstance(instance, torch.Tensor) else instance)
    T, F = x.shape
    if background is None:
        background = np.broadcast_to(x.mean(axis=0, keepdims=True), x.shape)
    windows = time_windows(T, size=window_size, stride=stride)
    M = len(windows)

    rng = np.random.default_rng(seed)
    if M >= 1 and 2**M <= n_coalitions:
        # exact mode: enumerate every coalition — kernel SHAP with the full
        # coalition set and the efficiency constraint IS the Shapley value
        # (cross-checked against brute-force Shapley in tests/test_xai.py)
        Z = np.asarray(
            [[(c >> m) & 1 for m in range(M)] for c in range(2**M)], dtype=float
        )
    else:
        # sampled mode: all-on, all-off, then random subsets
        Z = [np.ones(M), np.zeros(M)]
        sizes = rng.integers(1, M, size=max(n_coalitions - 2, 0))
        for s in sizes:
            z = np.zeros(M)
            z[rng.choice(M, s, replace=False)] = 1.0
            Z.append(z)
        Z = np.stack(Z)  # (C, M)

    # build masked instances: window m off -> replaced by background
    cell_mask = np.zeros((M, T), dtype=bool)
    for m, (lo, hi) in enumerate(windows):
        cell_mask[m, lo:hi] = True
    keep = np.ones((len(Z), T), dtype=bool)
    for m in range(M):
        off = Z[:, m] == 0
        keep[off] &= ~cell_mask[m][None, :]
    batch = np.where(keep[:, :, None], x[None], background[None]).astype(np.float32)

    vals = score_fn(torch.from_numpy(batch).to(device)).detach().cpu().numpy()  # (C,)
    sizes_z = Z.sum(axis=1).astype(int)
    base = float(vals[sizes_z == 0][0])
    full = float(vals[sizes_z == M][0])

    if M == 1:
        phi = np.asarray([full - base])
    else:
        # constrained WLS on interior coalitions (the endpoints are exact by
        # construction): intercept pinned to base, efficiency enforced by
        # eliminating phi_{M-1} = (full - base) - sum(phi_others) — the
        # standard kernel-SHAP solve
        interior = (sizes_z > 0) & (sizes_z < M)
        A = Z[interior]
        y = vals[interior] - base
        w = np.asarray([_shapley_kernel_weight(M, int(s)) for s in sizes_z[interior]])
        A2 = A[:, :-1] - A[:, -1:]
        y2 = y - A[:, -1] * (full - base)
        AtW = A2.T * w[None, :]
        phi_head = np.linalg.solve(
            AtW @ A2 + 1e-10 * np.eye(M - 1), AtW @ y2
        )
        phi = np.concatenate([phi_head, [(full - base) - phi_head.sum()]])

    # distribute each window's phi uniformly over its cells, average overlaps
    heat = np.zeros((T, F))
    counts = np.zeros((T, 1))
    for m, (lo, hi) in enumerate(windows):
        heat[lo:hi] += phi[m] / (hi - lo) / F
        counts[lo:hi] += 1
    return heat / np.maximum(counts, 1.0)
