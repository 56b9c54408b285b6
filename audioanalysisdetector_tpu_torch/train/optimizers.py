"""Optimizer zoo — the reference's optimizer maps (PyTorch).

Counterpart of the JAX package's ``train/optimizers.py``: {Adam, AdamW,
SGD(momentum=0.9), RMSprop} by name with torch-default hyperparameters.
``make_optimizer`` returns a factory, ``params -> torch.optim.Optimizer``
(``TrainState.create`` calls it on the model's parameters), as optax's
transformation is built before it meets the parameters.

Adam, AdamW and SGD are torch's own: their updates equal optax's (Adam's
eps outside the root; AdamW's decay ``p (1 - lr wd)`` beside the Adam step;
SGD's trace starting from the first gradient). RMSprop is not:
``optax.rmsprop(lr, decay=0.99, eps=1e-8)`` puts eps INSIDE the root
(``scale_by_rms(eps_in_sqrt=True)``), ``torch.optim.RMSprop`` outside it. For
a first-step gradient of 1e-4 the two step sizes differ about tenfold
(``rsqrt(1e-10 + 1e-8)`` against ``1 / (1e-5 + 1e-8)``), so the port has its
own ``RMSprop`` with optax's rule.
"""

from __future__ import annotations

from functools import partial
from typing import Callable

import torch


class RMSprop(torch.optim.Optimizer):
    """optax's RMSprop: ``nu = decay nu + (1 - decay) g^2`` from ``nu = 0``,
    then ``p -= lr g / sqrt(nu + eps)``. Per-parameter state: ``nu``."""

    def __init__(self, params, lr: float = 1e-4, decay: float = 0.99, eps: float = 1e-8):
        super().__init__(params, {"lr": lr, "decay": decay, "eps": eps})

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            lr, decay, eps = group["lr"], group["decay"], group["eps"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if "nu" not in state:
                    state["nu"] = torch.zeros_like(p)
                nu = state["nu"]
                nu.mul_(decay).addcmul_(p.grad, p.grad, value=1.0 - decay)
                p.addcmul_(p.grad, torch.rsqrt(nu + eps), value=-lr)
        return loss


def make_optimizer(
    name: str, lr: float = 1e-4, *, weight_decay: float = 1e-2
) -> Callable[..., torch.optim.Optimizer]:
    if name == "Adam":
        return partial(torch.optim.Adam, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    if name == "AdamW":
        return partial(torch.optim.AdamW, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                       weight_decay=weight_decay)
    if name == "SGD":
        # plain heavy-ball momentum, no dampening, no nesterov
        return partial(torch.optim.SGD, lr=lr, momentum=0.9, nesterov=False)
    if name == "RMSprop":
        return partial(RMSprop, lr=lr, decay=0.99, eps=1e-8)
    raise ValueError(f"unknown optimizer {name!r}")


OPTIMIZERS = ("Adam", "AdamW", "SGD", "RMSprop")
