"""Train and eval steps (PyTorch).

Counterpart of the JAX package's ``train/steps.py``: a step is forward,
backward, optimizer update and metrics on the model's device. The model and
its optimizer are updated in place (``TrainState``), and the dropout masks
come from the ``torch.Generator`` the caller hands in. Both ``make_*`` turn
TF32 off for the process (``score.fused.ieee_fp32``): cuDNN's convolution
backward would otherwise run in TF32.

The data-parallel ``make_dp_train_step``, ``shard_batch`` and ``replicate``
are ROADMAP Queue 1 step 9.
"""

from __future__ import annotations

from typing import Callable

import torch

from audioanalysisdetector_tpu_torch.train.state import TrainState


def _ieee_fp32() -> None:
    from audioanalysisdetector_tpu_torch.score.fused import ieee_fp32  # imports train.metrics

    ieee_fp32()


def _check_stats(state: TrainState, has_batch_stats: bool) -> None:
    if not has_batch_stats and state.has_batch_stats:
        raise ValueError("has_batch_stats=False, but the model holds BatchNorm statistics")


def _preds(logits: torch.Tensor, binary_head: bool) -> torch.Tensor:
    if binary_head:
        return (logits.reshape(-1) > 0).to(torch.int64)
    return torch.argmax(logits, dim=-1)


def make_train_step(
    loss_fn: Callable,
    *,
    has_batch_stats: bool = True,
    binary_head: bool = False,
    augment_fn: Callable | None = None,
) -> Callable:
    """Build ``step(state, x, y, generator) -> (state, metrics)``.

    ``loss_fn(logits, labels)`` is any entry of the loss zoo; ``x`` is one
    tensor or a tuple of inputs (multi-input models), ``y`` integer labels,
    all on the model's device. ``binary_head``: a single-logit head,
    predictions ``logits > 0``. ``has_batch_stats=False`` refuses a model
    holding BatchNorm statistics (the JAX step cannot update them either).
    ``augment_fn(x, generator) -> x`` runs train-time augmentation before
    the forward pass, one draw per branch for tuple inputs. ``metrics``
    holds 0-d tensors ``loss`` and ``accuracy`` on the device: no host sync.
    """
    _ieee_fp32()

    def step(state: TrainState, x, y: torch.Tensor, generator: torch.Generator):
        _check_stats(state, has_batch_stats)
        if augment_fn is not None:
            # one draw PER BRANCH: a shared draw would erase the same region
            # from every same-shaped feature input at once
            x = tuple(augment_fn(xi, generator) for xi in x) if isinstance(x, tuple) else augment_fn(x, generator)
        xs = x if isinstance(x, tuple) else (x,)
        model = state.model.train()
        logits = model(*xs, generator=generator)
        loss = loss_fn(logits, y)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        with torch.no_grad():
            acc = (_preds(logits, binary_head) == y).to(torch.float32).mean()
        state.apply_gradients()
        return state, {"loss": loss.detach(), "accuracy": acc}

    return step


def make_eval_step(
    loss_fn: Callable, *, has_batch_stats: bool = True, binary_head: bool = False
) -> Callable:
    """Build ``step(state, x, y) -> {"loss", "accuracy", "scores", "preds"}``
    in eval mode (running BatchNorm statistics, no dropout): ``scores`` are
    the sigmoid of a binary head's logit, else ``softmax[..., 1]``."""
    _ieee_fp32()

    @torch.no_grad()
    def step(state: TrainState, x, y: torch.Tensor):
        _check_stats(state, has_batch_stats)
        xs = x if isinstance(x, tuple) else (x,)
        logits = state.model.eval()(*xs)
        loss = loss_fn(logits, y)
        preds = _preds(logits, binary_head)
        if binary_head:
            scores = torch.sigmoid(logits.reshape(-1))
        else:
            scores = torch.softmax(logits, dim=-1)[..., 1]
        acc = (preds == y).to(torch.float32).mean()
        return {"loss": loss, "accuracy": acc, "scores": scores, "preds": preds}

    return step
