"""Cross-model attribution comparison + salient-interval extraction (PyTorch).

Counterpart of the JAX package's ``xai/compare.py`` (``compare_gmm_bilstm``
/ ``extract_top_intervals_global`` / ``plot_heatmaps_separately_stylish``,
reference/tets_xai.py:94-186): GMM kernel-SHAP, BiLSTM integrated gradients
and occlusion on one instance, heatmaps and reductions bundled, and the
top-N salient time intervals (threshold 1e-2, at least 0.2 s at hop 512 /
16 kHz frame time).

The plots need matplotlib; without it they are skipped with one line on
stderr and no path is returned.
"""

from __future__ import annotations

import os
import sys
from typing import Callable

import numpy as np
import torch

from audioanalysisdetector_tpu_torch.xai.attribution import bilstm_heatmaps
from audioanalysisdetector_tpu_torch.xai.shap_gmm import gmm_shap


def _device_of(model) -> torch.device:
    if isinstance(model, torch.nn.Module):
        return next(model.parameters()).device
    return torch.device("cpu")


def compare_gmm_bilstm(
    instance,
    *,
    bilstm_model: Callable,
    gmm_score_fn: Callable,
    ig_steps: int = 50,
    shap_coalitions: int = 128,
    seed: int = 0,
    device: str | torch.device | None = None,
) -> dict:
    """``instance``: (T, F) scaled CQCC. ``bilstm_model`` maps (B, T, F) to
    logits (the ``BiLSTMClassifier``; its gradient runs through cuDNN's LSTM
    on the card, ``xai.attribution.inference_mode_for_grad``);
    ``gmm_score_fn`` maps a (B, T, F) tensor on ``device`` (default the
    model's) to (B,) probabilities. Returns heatmaps + importances."""
    device = _device_of(bilstm_model) if device is None else torch.device(device)
    x = torch.as_tensor(np.asarray(instance, np.float32) if not isinstance(instance, torch.Tensor) else instance)
    x = x.to(device)[None]  # (1, T, F)
    nn_maps = bilstm_heatmaps(bilstm_model, x, steps=ig_steps)
    shap_map = gmm_shap(gmm_score_fn, x[0].cpu().numpy(), n_coalitions=shap_coalitions, seed=seed, device=device)

    def host(t: torch.Tensor) -> np.ndarray:
        return t[0].detach().cpu().numpy()

    return {
        "heatmaps": {
            "gmm_shap": shap_map,  # (T, F)
            "bilstm_ig": host(nn_maps["ig"]),
            "bilstm_occlusion": host(nn_maps["occlusion"]),
        },
        "importance": {
            "feature_importance": host(nn_maps["feature_importance"]),
            "time_importance": host(nn_maps["time_importance"]),
        },
    }


def extract_top_intervals_global(
    heatmap: np.ndarray,
    *,
    top_n: int = 3,
    threshold: float = 1e-2,
    min_duration_s: float = 0.2,
    hop_length: int = 512,
    sr: int = 16000,
) -> list[tuple[float, float, float]]:
    """Top-N (start_s, end_s, mean_saliency) intervals where the per-frame
    |saliency| exceeds ``threshold`` for at least ``min_duration_s``
    (reference/tets_xai.py:131-160 semantics)."""
    heatmap = np.asarray(heatmap)
    per_frame = np.abs(heatmap).mean(axis=-1) if heatmap.ndim == 2 else np.abs(heatmap)
    frame_time = hop_length / sr
    active = per_frame > threshold
    intervals = []
    start = None
    for i, a in enumerate(np.append(active, False)):
        if a and start is None:
            start = i
        elif not a and start is not None:
            dur = (i - start) * frame_time
            if dur >= min_duration_s:
                intervals.append(
                    (start * frame_time, i * frame_time, float(per_frame[start:i].mean()))
                )
            start = None
    intervals.sort(key=lambda t: -t[2])
    return intervals[:top_n]


def have_matplotlib(what: str) -> bool:
    """True when matplotlib imports (its backend set to Agg); else one line
    on stderr saying ``what`` is skipped."""
    try:
        import matplotlib
    except ImportError:
        print(f"matplotlib is not installed: {what} skipped", file=sys.stderr)
        return False
    matplotlib.use("Agg")
    return True


def render_heatmap_figure(heatmap: np.ndarray, title: str):
    """One styled heatmap figure (needs matplotlib) — the render shared by
    ``plot_heatmaps`` (PNG files) and ``xai.report`` (inline base64).
    ``heatmap`` is (T, F) time-major; the transpose puts time on x."""
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 4))
    im = ax.imshow(np.asarray(heatmap).T, aspect="auto", origin="lower", cmap="magma")
    ax.set_xlabel("time frame")
    ax.set_ylabel("coefficient")
    ax.set_title(title)
    fig.colorbar(im, ax=ax)
    fig.tight_layout()
    return fig


def plot_heatmaps(heatmaps: dict[str, np.ndarray], out_dir: str, *, prefix: str = "xai") -> list[str]:
    """Save one PNG per heatmap (reference's stylish-heatmap role); no paths
    without matplotlib."""
    if not have_matplotlib(f"heatmap PNGs in {out_dir}"):
        return []
    import matplotlib.pyplot as plt

    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for name, hm in heatmaps.items():
        fig = render_heatmap_figure(hm, name)
        path = os.path.join(out_dir, f"{prefix}_{name}.png")
        fig.savefig(path, dpi=100)
        plt.close(fig)
        paths.append(path)
    return paths
