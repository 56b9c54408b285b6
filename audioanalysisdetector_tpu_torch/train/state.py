"""Train state: the model (parameters and BatchNorm statistics), its optimizer and the step (PyTorch).

Counterpart of the JAX package's ``train/state.py``. A flax ``TrainState``
is immutable, so ``best_state = state`` in its ``fit`` keeps the arrays of
that epoch; here the model and optimizer are updated in place, so a state
that must outlive later steps is taken with ``copy()``.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Callable

import torch
from torch import nn


@dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0

    @classmethod
    def create(cls, *, model: nn.Module, tx: Callable[..., torch.optim.Optimizer]) -> "TrainState":
        """``tx`` is an optimizer factory (``train.optimizers.make_optimizer``)."""
        return cls(model=model, optimizer=tx(model.parameters()))

    @property
    def has_batch_stats(self) -> bool:
        return any(isinstance(m, nn.modules.batchnorm._BatchNorm) for m in self.model.modules())

    def apply_gradients(self) -> "TrainState":
        """One optimizer update from the gradients the parameters hold."""
        self.optimizer.step()
        self.step += 1
        return self

    def copy(self) -> "TrainState":
        """An independent copy: model and optimizer copied together, so the
        copy's optimizer holds the copy's parameters. The copy's LSTM
        weights are packed into cuDNN's one buffer again (a deep copy leaves
        them apart, and cuDNN would repack them on every call)."""
        out = copy.deepcopy(self)
        for m in out.model.modules():
            if isinstance(m, nn.RNNBase):
                m.flatten_parameters()
        return out


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
