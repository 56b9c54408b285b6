"""LIME-style perturbation explanations for the GMM⊕BiLSTM system (PyTorch).

Counterpart of the JAX package's ``xai/lime.py`` (reference/xai_func.py):
perturbation primitives (random coefficient rows replaced by their means,
:451-463; time slices replaced by their means, :421-449), the
cosine-distance kernel ``sqrt(exp(-d^2 / 0.25^2))`` (:360-388) and a
weighted linear-regression surrogate over the perturbation masks (:38-176,
:178-296).

The JAX perturbations draw with ``jax.random``; here each draws its uniform
scores from a ``torch.Generator`` (a CPU one in the drivers, so the card and
the CPU perturb alike) and is a function of those draws
(``features_mean_from_scores``, ``segments_from_scores``), which the tests
hold to the JAX functions fed JAX's draws. Perturbations are batched on the
instance's device. The surrogate fit stays on the host: the same weighted
least squares with an intercept as sklearn's ``LinearRegression`` with
sample weights (``fit_surrogate``), in numpy, so no sklearn is needed.
"""

from __future__ import annotations

import pickle
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch


def _changed(scores: torch.Tensor, n_changed: int) -> torch.Tensor:
    """The ``n_changed`` smallest draws of each row (``scores <= the
    n_changed-th smallest``; ties have measure zero)."""
    if n_changed <= 0:
        return torch.zeros_like(scores, dtype=torch.bool)
    thresh = torch.sort(scores, dim=-1).values[..., n_changed - 1 : n_changed]
    return scores <= thresh


def features_mean_from_scores(
    x: torch.Tensor, scores: torch.Tensor, *, n_changed: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """``perturb_random_features_mean`` given its draws: ``x`` (..., F, T),
    ``scores`` (..., F) uniform draws (leading axes batch perturbations)."""
    changed = _changed(scores, n_changed)
    row_means = x.mean(dim=-1, keepdim=True)
    perturbed = torch.where(changed[..., None], row_means, x)
    return perturbed, (~changed).to(torch.float32)


def perturb_random_features_mean(
    x: torch.Tensor, generator: torch.Generator, *, n_changed: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Replace ``n_changed`` random coefficient rows of ``(F, T)`` with their
    row means. Returns (perturbed, mask) with mask (F,) — 0 where changed
    (the reference's convention: active = 1)."""
    scores = torch.rand(x.shape[-2], generator=generator, device=generator.device).to(x.device)
    return features_mean_from_scores(x, scores, n_changed=n_changed)


def signal_segmentation(T: int, num_slices: int) -> np.ndarray:
    """Slice boundaries over the time axis (host, static)."""
    edges = np.linspace(0, T, num_slices + 1).astype(int)
    return np.stack([edges[:-1], edges[1:]], axis=1)  # (num_slices, 2)


def segments_from_scores(
    x: torch.Tensor, scores: torch.Tensor, *, num_slices: int, n_changed: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """``perturb_segments`` given its draws: ``x`` (..., F, T), ``scores``
    (..., num_slices)."""
    changed = _changed(scores, n_changed)
    out = x
    for s, (lo, hi) in enumerate(signal_segmentation(x.shape[-1], num_slices)):
        slice_mean = x[..., lo:hi].mean(dim=-1, keepdim=True)
        filled = out.clone()
        filled[..., lo:hi] = slice_mean
        out = torch.where(changed[..., s, None, None], filled, out)
    return out, (~changed).to(torch.float32)


def perturb_segments(
    x: torch.Tensor, generator: torch.Generator, *, num_slices: int, n_changed: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Replace ``n_changed`` random time slices of ``(F, T)`` with their
    per-slice means. Returns (perturbed, mask (num_slices,))."""
    scores = torch.rand(num_slices, generator=generator, device=generator.device).to(x.device)
    return segments_from_scores(x, scores, num_slices=num_slices, n_changed=n_changed)


def kernel_weights(masks: np.ndarray, *, width: float = 0.25) -> np.ndarray:
    """Cosine-distance LIME kernel: ``sqrt(exp(-d^2 / width^2))`` to all-ones
    (reference/xai_func.py:360-388)."""
    ones = np.ones(masks.shape[1])
    dots = masks @ ones
    norms = np.linalg.norm(masks, axis=1) * np.linalg.norm(ones)
    cos_sim = np.where(norms > 0, dots / np.maximum(norms, 1e-12), 0.0)
    d = 1.0 - cos_sim
    return np.sqrt(np.exp(-(d**2) / width**2))


@dataclass
class LinearSurrogate:
    """A fitted weighted linear model: ``coef_`` (n_features,) and
    ``intercept_``, as sklearn's ``LinearRegression`` exposes them."""

    coef_: np.ndarray
    intercept_: float

    def predict(self, X: np.ndarray) -> np.ndarray:
        return np.asarray(X, np.float64) @ self.coef_ + self.intercept_


def fit_surrogate(masks: np.ndarray, scores: np.ndarray, weights: np.ndarray) -> LinearSurrogate:
    """Weighted least squares with an intercept, as sklearn's
    ``LinearRegression().fit(masks, scores, sample_weight=weights)`` solves
    it: center by the weighted means, scale rows by sqrt(weight), the
    minimum-norm least-squares solution (the masks of one mode have a
    constant row sum, so the columns and the intercept are dependent), the
    intercept from the means. In float64."""
    X = np.asarray(masks, np.float64)
    y = np.asarray(scores, np.float64)
    w = np.asarray(weights, np.float64)
    x_off = np.average(X, axis=0, weights=w)
    y_off = np.average(y, weights=w)
    sw = np.sqrt(w)[:, None]
    coef, *_ = np.linalg.lstsq((X - x_off) * sw, (y - y_off) * sw[:, 0],
                               rcond=max(X.shape) * np.finfo(np.float64).eps)
    return LinearSurrogate(coef_=coef, intercept_=float(y_off - x_off @ coef))


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def lime_single_instance(
    scorer: Callable,
    instance,
    *,
    mode: str = "feature",
    n_perturbations: int = 30,
    num_slices: int = 9,
    n_changed: int = 4,
    top_k: int = 5,
    seed: int = 0,
    device: str | torch.device | None = None,
):
    """Single-instance LIME (reference ``test_lime_on_single_instance``,
    reference/xai_func.py:178-296).

    ``scorer`` maps a batch of instances (B, F, T) -> spoof scores (B,);
    ``instance`` is one (F, T) feature map (array or tensor; on ``device``,
    default its own). All perturbations draw from one CPU generator seeded
    by ``seed`` and are scored in one call. Returns a dict with the
    surrogate, the top-k influential components and the instance's own
    score."""
    x = torch.as_tensor(instance)
    x = x.to(device) if device is not None else x
    g = torch.Generator().manual_seed(seed)
    if mode == "feature":
        scores_u = torch.rand((n_perturbations, x.shape[-2]), generator=g).to(x.device)
        batch, masks_d = features_mean_from_scores(x, scores_u, n_changed=n_changed)
    elif mode == "time":
        scores_u = torch.rand((n_perturbations, num_slices), generator=g).to(x.device)
        batch, masks_d = segments_from_scores(x, scores_u, num_slices=num_slices, n_changed=n_changed)
    else:
        raise ValueError(f"unknown LIME mode {mode!r}")
    scores = _host(scorer(batch))
    masks = _host(masks_d)
    weights = kernel_weights(masks)
    reg = fit_surrogate(masks, scores, weights)

    coefs = reg.coef_
    top = np.argsort(-np.abs(coefs))[:top_k]
    own_score = float(_host(scorer(x[None]))[0])
    return {
        "surrogate": reg,
        "coefficients": coefs,
        "top_components": top.tolist(),
        "score": own_score,
        "label": int(own_score > 0.5),
        "masks": masks,
        "perturbation_scores": scores,
        "weights": weights,
    }


def lime_dataset(
    scorer: Callable,
    instances,
    *,
    mode: str = "feature",
    num_slices: int = 9,
    n_changed: int = 4,
    seed: int = 0,
    save_path: str | None = None,
    device: str | torch.device | None = None,
):
    """Dataset-level LIME (reference ``prepare_pertubation_data_GMM_BiLSTM``,
    reference/xai_func.py:38-176): perturb every instance once (one draw row
    each), re-score the perturbed set, fit one weighted surrogate over all
    masks; ``save_path`` pickles the surrogate."""
    xs = torch.stack([torch.as_tensor(i) for i in instances])
    xs = xs.to(device) if device is not None else xs
    g = torch.Generator().manual_seed(seed)
    if mode == "feature":
        scores_u = torch.rand((len(xs), xs.shape[-2]), generator=g).to(xs.device)
        perturbed, masks_d = features_mean_from_scores(xs, scores_u, n_changed=n_changed)
    else:
        scores_u = torch.rand((len(xs), num_slices), generator=g).to(xs.device)
        perturbed, masks_d = segments_from_scores(xs, scores_u, num_slices=num_slices, n_changed=n_changed)
    # invariant the reference asserts (reference/xai_func.py:91-92)
    assert perturbed.shape == xs.shape
    scores = _host(scorer(perturbed))
    masks = _host(masks_d)
    weights = kernel_weights(masks)
    reg = fit_surrogate(masks, scores, weights)
    if save_path:
        with open(save_path, "wb") as f:
            pickle.dump(reg, f)
    return {"surrogate": reg, "masks": masks, "scores": scores, "weights": weights}
