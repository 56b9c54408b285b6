"""Gradient and perturbation attribution: saliency, IG, occlusion, Grad-CAM (PyTorch).

Counterpart of the JAX package's ``xai/attribution.py`` (the reference's
Captum usage, reference/tets_xai.py:70-91 — IntegratedGradients with a zero
baseline and Occlusion with a (5, 1) window over (T, F) inputs;
ASV_deep_learning.ipynb cell 34 — LayerGradCam on the last residual block),
on autograd. Where the JAX functions take ``(apply_fn, variables, x)``, these
take ``model``: a callable from ``x`` to logits, usually the ``nn.Module``
itself.

A module is called in eval mode (the JAX ``train=False``), except its
recurrent layers: cuDNN's RNN backward runs only in training mode, so for
the gradient every ``nn.RNNBase`` inside is put in training mode (the port's
LSTMs have one layer each, so no inter-layer dropout applies and the output
is the same) and every module's mode is restored afterwards.

Attributions start from features made under ``torch.no_grad()``: the mel
kernels have no backward (``ops.refuse_grad``). Each turns TF32 off for the
process (``score.fused.ieee_fp32``): cuDNN would otherwise run the
convolutions in TF32.
"""

from __future__ import annotations

import contextlib
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from audioanalysisdetector_tpu_torch.score.fused import ieee_fp32

# positions scored per batched forward, as ``lax.map(batch_size=64)``
OCCLUSION_CHUNK = 64


@contextlib.contextmanager
def inference_mode_for_grad(model: Callable):
    """``model`` (when a module) in eval mode with its RNNs in training mode,
    for the duration; every submodule's mode restored after. TF32 off."""
    ieee_fp32()
    if not isinstance(model, nn.Module):
        yield
        return
    modes = [(m, m.training) for m in model.modules()]
    model.eval()
    for m in model.modules():
        if isinstance(m, nn.RNNBase):
            m.train()
    try:
        yield
    finally:
        for m, mode in modes:
            m.training = mode


def _target_score(model: Callable, x: torch.Tensor, target: int) -> torch.Tensor:
    out = model(x)
    if out.shape[-1] == 1:  # sigmoid / logit single head
        return out[..., 0]
    return out[..., target]


def _grad(model: Callable, x: torch.Tensor, target: int) -> torch.Tensor:
    """d sum(score_target) / d x."""
    with torch.enable_grad():
        xi = x.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(_target_score(model, xi, target).sum(), xi)
    return g


def saliency(model: Callable, x: torch.Tensor, *, target: int = 1) -> torch.Tensor:
    """|d score_target / d x| per input element (vanilla gradient saliency)."""
    with inference_mode_for_grad(model):
        return _grad(model, x, target).abs()


def integrated_gradients(
    model: Callable,
    x: torch.Tensor,
    *,
    target: int = 1,
    steps: int = 50,
    baseline: torch.Tensor | None = None,
) -> torch.Tensor:
    """Riemann-sum integrated gradients from ``baseline`` (default zeros),
    Captum's contract (reference/tets_xai.py:75-78) at the JAX package's
    midpoint alphas ``(k + 0.5) / steps``, one step at a time."""
    if baseline is None:
        baseline = torch.zeros_like(x)
    delta = x - baseline
    total = torch.zeros_like(x)
    alphas = (torch.arange(steps, dtype=x.dtype) + 0.5) / steps
    with inference_mode_for_grad(model):
        for alpha in alphas.to(x.device):
            total = total + _grad(model, baseline + alpha * delta, target)
    return delta * total / steps


@torch.no_grad()
def occlusion(
    model: Callable,
    x: torch.Tensor,
    *,
    target: int = 1,
    window: tuple[int, int] = (5, 1),
    baseline: float = 0.0,
) -> torch.Tensor:
    """Sliding-window occlusion over the last two axes of ``x`` (B, T, F).

    Each position's attribution is the score drop when the window covering
    it is replaced by ``baseline``; overlapping windows average (Captum
    semantics, stride 1). Positions are scored ``OCCLUSION_CHUNK`` windows
    per batched forward. The heat is a FULL correlation of the (n_t, n_f)
    grid of score drops with a ones window, divided by the overlap counts:
    no (P, T, F) mask is ever built."""
    B, T, Fd = x.shape
    wt, wf = window
    n_t, n_f = T - wt + 1, Fd - wf + 1
    pos = torch.stack(torch.meshgrid(torch.arange(n_t), torch.arange(n_f), indexing="ij"), -1).reshape(-1, 2)
    pos = pos.to(x.device)
    t_idx = torch.arange(T, device=x.device)
    f_idx = torch.arange(Fd, device=x.device)
    with inference_mode_for_grad(model):
        base_score = _target_score(model, x, target)  # (B,)
        diffs = []
        for lo in range(0, len(pos), OCCLUSION_CHUNK):
            p = pos[lo : lo + OCCLUSION_CHUNK]  # (c, 2)
            t0, f0 = p[:, 0, None, None], p[:, 1, None, None]
            mask = ((t_idx[:, None] >= t0) & (t_idx[:, None] < t0 + wt)
                    & (f_idx[None, :] >= f0) & (f_idx[None, :] < f0 + wf))  # (c, T, F)
            x_occ = torch.where(mask[:, None], torch.tensor(baseline, dtype=x.dtype, device=x.device), x[None])
            score = _target_score(model, x_occ.reshape(-1, T, Fd), target).reshape(len(p), B)
            diffs.append(base_score[None] - score)
    grid = torch.cat(diffs).T.reshape(B, 1, n_t, n_f)
    kernel = torch.ones((1, 1, wt, wf), dtype=x.dtype, device=x.device)
    heat = F.conv2d(grid, kernel, padding=(wt - 1, wf - 1))[:, 0]  # (B, T, F)
    counts = F.conv2d(torch.ones((1, 1, n_t, n_f), dtype=x.dtype, device=x.device), kernel,
                      padding=(wt - 1, wf - 1))[0, 0]
    return heat / counts.clamp_min(1.0)


def resize_bilinear(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """``jax.image.resize(x, (..., *size), "bilinear")`` of ``(B, H, W)``
    maps for an upsampling (half-pixel centres, no antialiasing, which JAX
    applies only when a map shrinks)."""
    return F.interpolate(x[:, None], size=tuple(size), mode="bilinear", align_corners=False,
                         antialias=False)[:, 0]


def grad_cam(
    model,
    x: torch.Tensor,
    *,
    target: int = 1,
    output_size: tuple[int, int] | None = None,
) -> torch.Tensor:
    """Grad-CAM on the last residual block of an ``AntiSpoofingResNet``-family
    model: channel weights are the spatially pooled gradients at
    ``feature_maps``; the CAM is the ReLU of the weighted channel sum,
    optionally resized to the input geometry (the reference's cv2.resize;
    ``resize_bilinear``)."""
    with inference_mode_for_grad(model):
        with torch.no_grad():
            fmap = model.feature_maps(x)  # (B, H, W, C)
        with torch.enable_grad():
            f = fmap.detach().requires_grad_(True)
            out = model.classify_features(f)
            score = out[..., 0] if out.shape[-1] == 1 else out[..., target]
            (grads,) = torch.autograd.grad(score.sum(), f)
    weights = grads.mean(dim=(1, 2), keepdim=True)  # GAP over space
    cam = torch.relu((weights * fmap).sum(dim=-1))  # (B, H, W)
    if output_size is not None:
        cam = resize_bilinear(cam, output_size)
    return cam


# ------------------------------------------------- reference reductions


def bilstm_heatmaps(
    model: Callable, x: torch.Tensor, *, target: int = 1, steps: int = 50
) -> dict[str, torch.Tensor]:
    """The reference's ``compute_bilstm_heatmaps`` reductions
    (reference/tets_xai.py:70-91): IG feature importance = mean |IG| over
    time; occlusion time importance = sum |occ| over features."""
    ig = integrated_gradients(model, x, target=target, steps=steps)
    occ = occlusion(model, x, target=target, window=(5, 1))
    return {
        "ig": ig,
        "occlusion": occ,
        "feature_importance": ig.abs().mean(dim=-2),  # (B, F)
        "time_importance": occ.abs().sum(dim=-1),  # (B, T)
    }
