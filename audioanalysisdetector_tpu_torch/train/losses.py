"""Loss zoo — the reference's criterion maps (PyTorch).

Counterpart of the JAX package's ``train/losses.py``. All losses take
``(logits, labels)`` with integer labels and reduce to a scalar mean:

- ``CrossEntropyLoss``: softmax cross-entropy;
- ``NLLLoss``: expects log-probabilities (torch's NLLLoss contract);
- ``MSELoss`` / ``L1Loss``: the softmax against one-hot targets;
- ``BCELoss``: a single-logit head, ``(B, 1)`` reshaped to ``(B,)``, in the
  numerically stable with-logits form.

``LOSSES_PER_ROW`` holds the unreduced forms: ``mean(per_row) ==`` the
scalar loss for every entry (``fit_bucketed`` masks repeated rows out).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def cross_entropy_per_row(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return F.cross_entropy(logits, labels.long(), reduction="none")


def nll_per_row(log_probs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return -torch.gather(log_probs, -1, labels.long()[:, None])[:, 0]


def _onehot_error(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    probs = torch.softmax(logits, dim=-1)
    return probs - F.one_hot(labels.long(), logits.shape[-1]).to(probs.dtype)


def mse_onehot_per_row(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return _onehot_error(logits, labels).square().mean(dim=-1)


def l1_onehot_per_row(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return _onehot_error(logits, labels).abs().mean(dim=-1)


def bce_with_logits_per_row(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Binary cross-entropy on a single-logit head; labels in {0, 1}."""
    logits = logits.reshape(logits.shape[0])
    return F.binary_cross_entropy_with_logits(
        logits, labels.to(logits.dtype).reshape(labels.shape[0]), reduction="none"
    )


LOSSES_PER_ROW = {
    "CrossEntropyLoss": cross_entropy_per_row,
    "NLLLoss": nll_per_row,
    "MSELoss": mse_onehot_per_row,
    "L1Loss": l1_onehot_per_row,
    "BCELoss": bce_with_logits_per_row,
}


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return cross_entropy_per_row(logits, labels).mean()


def nll(log_probs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return nll_per_row(log_probs, labels).mean()


def mse_onehot(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return _onehot_error(logits, labels).square().mean()


def l1_onehot(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return _onehot_error(logits, labels).abs().mean()


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return bce_with_logits_per_row(logits, labels).mean()


LOSSES = {
    "CrossEntropyLoss": cross_entropy,
    "NLLLoss": nll,
    "MSELoss": mse_onehot,
    "L1Loss": l1_onehot,
    "BCELoss": bce_with_logits,
}


def get_loss(name: str):
    if name not in LOSSES:
        raise ValueError(f"unknown loss {name!r}; available: {sorted(LOSSES)}")
    return LOSSES[name]


def get_loss_per_row(name: str):
    if name not in LOSSES_PER_ROW:
        raise ValueError(f"unknown loss {name!r}; available: {sorted(LOSSES_PER_ROW)}")
    return LOSSES_PER_ROW[name]
