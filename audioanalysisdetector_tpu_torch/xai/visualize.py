"""Perturbation visualizers (reference/xai_func.py:297-357, 465-525 roles) (PyTorch).

Counterpart of the JAX package's ``xai/visualize.py``: per-coefficient
original-vs-perturbed line plots with changed rows / time slices
highlighted, and the Grad-CAM overlay, saved as PNGs (headless-friendly).
Each needs matplotlib; without it the plot is skipped with one line on
stderr and ``None`` is returned in place of its path.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from audioanalysisdetector_tpu_torch.xai.attribution import resize_bilinear
from audioanalysisdetector_tpu_torch.xai.compare import have_matplotlib
from audioanalysisdetector_tpu_torch.xai.lime import signal_segmentation


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def visualize_feature_perturbation(
    original: np.ndarray,
    perturbed: np.ndarray,
    mask: np.ndarray,
    *,
    out_path: str = "xai_out/perturbation_features.png",
    max_rows: int = 8,
) -> str | None:
    """Line plots per coefficient row; perturbed (mask==0) rows highlighted."""
    if not have_matplotlib(out_path):
        return None
    import matplotlib.pyplot as plt

    original = _host(original)
    perturbed = _host(perturbed)
    changed = np.where(_host(mask) == 0)[0]
    show = list(changed[: max_rows // 2])
    show += [i for i in range(original.shape[0]) if i not in show][: max_rows - len(show)]
    show.sort()

    fig, axes = plt.subplots(len(show), 1, figsize=(8, 1.6 * len(show)), sharex=True)
    for ax, r in zip(np.atleast_1d(axes), show):
        ax.plot(original[r], lw=1, label="original")
        ax.plot(perturbed[r], lw=1, ls="--", label="perturbed")
        tag = " (changed)" if r in changed else ""
        ax.set_ylabel(f"c{r}{tag}", fontsize=8)
        if r in changed:
            ax.set_facecolor("#fff3e0")
    np.atleast_1d(axes)[0].legend(loc="upper right", fontsize=8)
    np.atleast_1d(axes)[-1].set_xlabel("time frame")
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.tight_layout()
    fig.savefig(out_path, dpi=100)
    plt.close(fig)
    return out_path


def plot_cqcc_pipeline(
    original: np.ndarray,
    perturbed: np.ndarray,
    info: dict,
    *,
    out_path: str = "xai_out/cqcc_pipeline.png",
    max_rows: int = 19,
    title: str | None = None,
) -> str | None:
    """Mode-dispatching perturbation panel — the reference's
    ``plot_cqcc_pipeline`` / ``plot_cqcc_perturbations``
    (reference/xai_func.py:465-525): one stacked subplot per CQCC
    coefficient with original vs perturbed traces overlaid.

    ``info``: ``{"mode": "time"|"feature", ...}`` with either
    ``"scales"`` (per-slice factors; slices whose scale is not 0/1 are
    shaded red if >1 else blue — the reference's coloring) or ``"mask"``
    (0 = perturbed; time mode shades masked slices, feature mode marks
    changed rows with the dashed row-mean line and tinted background,
    matching ``lime_*``'s mean-replacement perturbations).
    """
    if not have_matplotlib(out_path):
        return None
    import matplotlib.pyplot as plt

    original = _host(original)
    perturbed = _host(perturbed)
    mode = info["mode"]
    if mode not in ("time", "feature"):
        raise ValueError(f"unknown perturbation mode {mode!r}")
    scales = np.asarray(info["scales"]) if info.get("scales") is not None else None
    mask = np.asarray(info["mask"]) if info.get("mask") is not None else None
    n_rows = min(original.shape[0], max_rows)

    fig, axes = plt.subplots(
        n_rows, 1, figsize=(12, 1.2 * n_rows), sharex=True
    )
    axes = np.atleast_1d(axes)
    t = np.arange(original.shape[-1])
    changed_rows: set[int] = set()
    if mode == "feature":
        if scales is not None:  # reference form: indices of changed rows
            changed_rows = set(int(i) for i in scales)
        elif mask is not None:
            changed_rows = set(np.where(mask == 0)[0].tolist())
    for i, ax in enumerate(axes):
        ax.plot(t, original[i], label="original", alpha=0.6, lw=1)
        ax.plot(t, perturbed[i], label="perturbed", alpha=0.8, lw=1)
        ax.set_ylabel(f"c{i}", fontsize=7)
        if mode == "time":
            if scales is not None:
                seg_len = original.shape[-1] // len(scales)
                for j, s in enumerate(scales):
                    if s not in (0.0, 1.0):
                        ax.axvspan(
                            j * seg_len, (j + 1) * seg_len,
                            color="red" if s > 1 else "blue", alpha=0.15,
                        )
            elif mask is not None:
                for j, (lo, hi) in enumerate(
                    signal_segmentation(original.shape[-1], len(mask))
                ):
                    if mask[j] == 0:
                        ax.axvspan(lo, hi, color="red", alpha=0.15)
        elif i in changed_rows:
            ax.axhline(
                float(np.mean(original[i])), color="red", ls="--", alpha=0.5
            )
            ax.set_facecolor((1, 0.9, 0.9))
    axes[-1].set_xlabel("time frame")
    axes[0].legend(loc="upper right", fontsize=7)
    fig.suptitle(title or f"CQCC perturbations ({mode} mode)")
    fig.tight_layout(rect=[0, 0, 1, 0.97])
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path, dpi=100)
    plt.close(fig)
    return out_path


def plot_gradcam_overlay(
    feature_db: np.ndarray,
    cam: np.ndarray,
    *,
    sr: int = 16000,
    hop_length: int = 512,
    fmax: float | None = None,
    out_path: str = "xai_out/gradcam_overlay.png",
    alpha: float = 0.45,
    title: str = "Grad-CAM on mel spectrogram",
) -> str | None:
    """Grad-CAM heat overlaid on the input spectrogram's own axes —
    the reference notebook's cv2-upsampled overlay figure
    (ASV_deep_learning.ipynb cell 34): dB mel background (gray), CAM in a
    hot colormap with transparency, seconds on x, mel band on y.

    ``feature_db``: (F, T) input map (as fed to the model);
    ``cam``: Grad-CAM from ``xai.attribution.grad_cam`` — any (h, w) grid,
    resized here to (F, T) (``xai.attribution.resize_bilinear``).
    """
    if not have_matplotlib(out_path):
        return None
    import matplotlib.pyplot as plt

    feature_db = _host(feature_db)
    cam = _host(cam)
    if cam.shape != feature_db.shape:  # reference upsamples with cv2.resize
        cam = resize_bilinear(torch.from_numpy(cam)[None], feature_db.shape)[0].numpy()
    span = float(cam.max() - cam.min())
    cam = (cam - cam.min()) / (span if span > 0 else 1.0)
    extent = [0.0, feature_db.shape[1] * hop_length / sr, 0.0, feature_db.shape[0]]

    fig, ax = plt.subplots(figsize=(10, 4))
    ax.imshow(
        feature_db, origin="lower", aspect="auto", cmap="gray_r", extent=extent
    )
    im = ax.imshow(
        cam, origin="lower", aspect="auto", cmap="inferno", alpha=alpha,
        extent=extent, vmin=0.0, vmax=1.0,
    )
    fig.colorbar(im, ax=ax, label="Grad-CAM (normalized)")
    ax.set_xlabel("time (s)")
    ax.set_ylabel(f"mel band{'' if fmax is None else f' (fmax {fmax:.0f} Hz)'}")
    ax.set_title(title)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.tight_layout()
    fig.savefig(out_path, dpi=100)
    plt.close(fig)
    return out_path


def visualize_segment_perturbation(
    original: np.ndarray,
    perturbed: np.ndarray,
    mask: np.ndarray,
    *,
    num_slices: int | None = None,
    out_path: str = "xai_out/perturbation_segments.png",
    rows: tuple[int, ...] = (0, 1, 2),
) -> str | None:
    """Coefficient traces with perturbed time slices shaded."""
    if not have_matplotlib(out_path):
        return None
    import matplotlib.pyplot as plt

    original = _host(original)
    perturbed = _host(perturbed)
    mask = _host(mask)
    num_slices = num_slices or len(mask)
    seg = signal_segmentation(original.shape[-1], num_slices)
    # clamp to the rows that exist (same rule as the feature variant)
    rows = tuple(r for r in rows if r < original.shape[0]) or (0,)

    fig, axes = plt.subplots(len(rows), 1, figsize=(8, 1.8 * len(rows)), sharex=True)
    for ax, r in zip(np.atleast_1d(axes), rows):
        ax.plot(original[r], lw=1, label="original")
        ax.plot(perturbed[r], lw=1, ls="--", label="perturbed")
        for s, (lo, hi) in enumerate(seg):
            if mask[s] == 0:
                ax.axvspan(lo, hi, color="orange", alpha=0.2)
        ax.set_ylabel(f"c{r}", fontsize=8)
    np.atleast_1d(axes)[0].legend(loc="upper right", fontsize=8)
    np.atleast_1d(axes)[-1].set_xlabel("time frame")
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.tight_layout()
    fig.savefig(out_path, dpi=100)
    plt.close(fig)
    return out_path
