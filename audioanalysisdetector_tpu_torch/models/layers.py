"""Training-mode layers with flax's rules, and flax's initialisation (PyTorch).

- ``Dropout``: ``flax.linen.Dropout``'s rule (keep with probability
  ``1 - rate``, scale by ``1 / (1 - rate)``), its mask drawn from the
  ``torch.Generator`` the caller hands in, never from torch's global RNG. The
  masks cannot match JAX's draws; parity runs use rate 0.
- ``FlaxBatchNorm1d``: ``nn.BatchNorm1d`` (same parameters, buffers and
  state-dict keys) whose training-mode running variance follows flax: the
  BIASED batch variance, where torch's own update takes the unbiased one.
- ``flax_init_``: parameters drawn from a generator with the distribution of
  the JAX package's ``model.init``: ``lecun_normal`` (a normal truncated at
  two standard deviations, fan-in scaled) kernels and zero biases for Conv
  and Dense, uniform in +-1/sqrt(H) for every LSTM tensor
  (``models/lstm.py:32`` of the JAX package), norm layers at scale 1 and
  bias 0, BatchNorm statistics at mean 0 and variance 1.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

# flax's truncated_normal: the std of a unit normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


class Dropout(nn.Module):
    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if generator is None:
            raise ValueError(
                "dropout in training mode draws its mask from an explicit "
                "torch.Generator (the train step hands one in), none was given"
            )
        if self.rate >= 1.0:
            return torch.zeros_like(x)
        keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - self.rate
        return torch.where(keep, x / (1.0 - self.rate), 0.0)


class FlaxBatchNorm1d(nn.BatchNorm1d):
    """``(B, C, L)`` BatchNorm: flax ``momentum=0.9`` is ``momentum=0.1`` here;
    in training mode the running mean and variance move by ``momentum``
    toward the batch mean and the biased batch variance over ``(B, L)``,
    computed as flax computes it."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        out = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
        with torch.no_grad():
            # flax's (fast) biased variance, E[x^2] - E[x]^2 clipped at 0
            mean = x.mean(dim=(0, 2))
            var = (x * x).mean(dim=(0, 2)).sub_(mean * mean).clamp_(min=0.0)
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
            self.num_batches_tracked.add_(1)
        return out


def flax_init_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Redraw every parameter of ``model`` in place, in module order, from
    ``generator`` (a CPU generator, whatever the model's device)."""

    def draw(t: torch.Tensor, fill) -> None:
        host = torch.empty(t.shape, dtype=torch.float32)
        fill(host)
        t.copy_(host)

    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (nn.Conv1d, nn.Linear)):
                std = mod.weight[0].numel() ** -0.5 / _TRUNC_STD
                draw(mod.weight, lambda h: nn.init.trunc_normal_(
                    h, 0.0, std, -2.0 * std, 2.0 * std, generator=generator))
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.LSTM):
                b = mod.hidden_size**-0.5
                for p in mod.parameters():
                    draw(p, lambda h: h.uniform_(-b, b, generator=generator))
            elif isinstance(mod, (nn.BatchNorm1d, nn.LayerNorm)):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
                if isinstance(mod, nn.BatchNorm1d):
                    mod.reset_running_stats()
    return model
