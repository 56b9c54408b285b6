"""Plain reference of the mel-parity training recipe's first steps: the
CNN-BiLSTM hybrid on log-mel, binary cross-entropy on its logit, Adam.

Written from the recipe (IzaP1k/AudioAnalysisDetector,
``ASV_deep_learning.ipynb`` cells 26-27: batch 200, Adam 1e-4; the model
``cnn_bilstm_hybrid.py:20-68``) in plain PyTorch, in float64 unless told
otherwise: features by ``mel_cnn_bilstm.log_mel``, the forward pass by
``mel_cnn_bilstm.model`` in training mode (batch statistics, dropout),
gradients by autograd, Adam written out (``m``, ``v``, bias corrections,
``eps`` outside the root).

Each step takes one batch as the recipe's loader hands it: its rows in the
order of a ``numpy.random.default_rng(seed).shuffle`` of their positions,
and its dropout masks drawn from a ``torch.Generator`` seeded with the same
``seed`` on the device (``mel_cnn_bilstm.dropout_masks``). Nothing here
imports the port.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import mel_cnn_bilstm as mel

STATS = ("bn.running_mean", "bn.running_var", "bn.num_batches_tracked")


def trainable(weights: dict) -> list[str]:
    """The leaves Adam moves: every weight but BatchNorm's statistics."""
    return [k for k in weights if k not in STATS]


def steps(cfg: dict, tr: dict, weights: dict, batches: list[tuple[torch.Tensor, torch.Tensor, int]], *,
          dtype: torch.dtype = torch.float64) -> dict:
    """Adam over ``batches`` of ``(waveforms, labels, seed)``: per step the
    loss, the first step's gradient per leaf, BatchNorm's running
    statistics after the first step (momentum 0.1 toward the batch's), and
    each leaf's change after the last step."""
    names = trainable(weights)
    params = {k: weights[k].to(dtype).clone() for k in names}
    fixed = {k: weights[k] for k in STATS if k in weights}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v = {k: torch.zeros_like(p) for k, p in params.items()}
    b1, b2, eps, lr = 0.9, 0.999, 1e-8, float(tr["lr"])
    losses, first_grad, bn_stats = [], None, None
    for t, (wav, labels, seed) in enumerate(batches, start=1):
        order = np.arange(len(labels))
        np.random.default_rng(seed).shuffle(order)
        idx = torch.from_numpy(order).to(wav.device)
        feats = mel.log_mel(wav[idx].to(dtype), cfg)
        gen = torch.Generator(device=wav.device).manual_seed(seed)
        masks = mel.dropout_masks(gen, len(labels), cfg, wav.device)
        leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
        batch_stats: dict = {}
        logits = mel.model(feats, {**leaves, **fixed}, cfg, masks=masks, stats=batch_stats)
        if bn_stats is None:
            bn_stats = {"bn.running_mean": 0.9 * weights["bn.running_mean"].to(dtype) + 0.1 * batch_stats["mean"],
                        "bn.running_var": 0.9 * weights["bn.running_var"].to(dtype) + 0.1 * batch_stats["var"]}
        loss = F.binary_cross_entropy_with_logits(logits, labels[idx].to(dtype))
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        losses.append(float(loss.detach()))
        with torch.no_grad():
            g = {k: (gr if gr is not None else torch.zeros_like(params[k])) for k, gr in zip(leaves, grads)}
            if first_grad is None:
                first_grad = g
            for k in names:
                m[k] = b1 * m[k] + (1 - b1) * g[k]
                v[k] = b2 * v[k] + (1 - b2) * g[k] * g[k]
                denom = (v[k] / (1 - b2**t)).sqrt() + eps
                params[k] = params[k] - lr * (m[k] / (1 - b1**t)) / denom
    change = {k: params[k] - weights[k].to(dtype) for k in names}
    return {"losses": losses, "first_grad": first_grad, "bn_stats": bn_stats, "change": change}
