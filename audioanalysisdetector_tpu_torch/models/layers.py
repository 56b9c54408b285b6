"""Training-mode layers with flax's rules, and flax's initialisation (PyTorch).

- ``Dropout``: ``flax.linen.Dropout``'s rule (keep with probability
  ``1 - rate``, scale by ``1 / (1 - rate)``), its mask drawn from the
  ``torch.Generator`` the caller hands in, never from torch's global RNG. The
  masks cannot match JAX's draws; parity runs use rate 0.
  ``ChannelDropout`` is flax's ``nn.Dropout(broadcast_dims=(1, 2))`` on
  channel-last maps: one mask entry per (sample, channel), here of
  ``(B, C, H, W)`` maps.
- ``FlaxBatchNorm1d`` / ``FlaxBatchNorm2d``: ``nn.BatchNorm1d`` /
  ``nn.BatchNorm2d`` (same parameters, buffers and state-dict keys) whose
  training-mode running variance follows flax: the BIASED batch variance,
  where torch's own update takes the unbiased one; with ``axis_name``,
  flax's sync-BN over a process group.
- ``flax_init_``: parameters drawn from a generator with the distribution of
  the JAX package's ``model.init``: ``lecun_normal`` (a normal truncated at
  two standard deviations, fan-in scaled; a grouped convolution's fan-in is
  ``kh * kw * in / groups``) kernels and zero biases for Conv and Dense,
  uniform in +-1/sqrt(H) for every LSTM tensor (``models/lstm.py:32`` of the
  JAX package), norm layers at scale 1 and bias 0, BatchNorm statistics at
  mean 0 and variance 1.
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
        keep = torch.rand(self._mask_shape(x), generator=generator, device=x.device) < 1.0 - self.rate
        return torch.where(keep, x / (1.0 - self.rate), 0.0)

    def _mask_shape(self, x: torch.Tensor) -> tuple[int, ...]:
        return tuple(x.shape)


class ChannelDropout(Dropout):
    """Dropout of whole channels of ``(B, C, ...)`` maps: one mask entry per
    (sample, channel), broadcast over the spatial axes."""

    def _mask_shape(self, x: torch.Tensor) -> tuple[int, ...]:
        return (*x.shape[:2], *(1,) * (x.dim() - 2))


class _FlaxBatchNorm:
    """flax's BatchNorm rule for ``(B, C, *spatial)``: flax ``momentum=0.9``
    is ``momentum=0.1`` here; in training mode the running mean and variance
    move by ``momentum`` toward the batch mean and the biased batch variance
    over every axis but C, computed as flax computes it.

    ``axis_name`` is flax's sync-BN: in training mode the batch mean and
    mean of squares are averaged over the ranks of the process group bound
    to that name (``parallel.mesh.axis_groups``, which the data-parallel
    step binds), the variance taken as E[x^2] - mean^2, and the rows
    normalized by those global moments, so every rank normalizes as one
    device would over the global batch and holds the same running
    statistics. Not ``nn.SyncBatchNorm``, whose Welford combine rounds
    otherwise."""

    def __init__(self, *args, axis_name: str | None = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.axis_name = axis_name

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if self.axis_name is not None:
            return self._synced(x)
        out = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
        with torch.no_grad():
            # flax's (fast) biased variance, E[x^2] - E[x]^2 clipped at 0
            dims = _reduce_dims(x)
            mean = x.mean(dim=dims)
            var = (x * x).mean(dim=dims).sub_(mean * mean).clamp_(min=0.0)
            self._update_running(mean, var)
        return out

    def _synced(self, x: torch.Tensor) -> torch.Tensor:
        from audioanalysisdetector_tpu_torch.parallel.mesh import all_reduce_sum, axis_group

        group = axis_group(self.axis_name)
        dims = _reduce_dims(x)
        moments = torch.stack([x.mean(dim=dims), (x * x).mean(dim=dims)])
        mean, mean2 = all_reduce_sum(moments, group) / torch.distributed.get_world_size(group)
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight
        per_channel = (-1, *(1,) * (x.dim() - 2))
        out = (x - mean.view(per_channel)) * mul.view(per_channel) + self.bias.view(per_channel)
        with torch.no_grad():
            self._update_running(mean, var)
        return out

    def _update_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        self.running_mean.lerp_(mean, self.momentum)
        self.running_var.lerp_(var, self.momentum)
        self.num_batches_tracked.add_(1)


def _reduce_dims(x: torch.Tensor) -> tuple[int, ...]:
    return (0, *range(2, x.dim()))


class FlaxBatchNorm1d(_FlaxBatchNorm, nn.BatchNorm1d):
    """``(B, C, L)`` BatchNorm with flax's rule (``_FlaxBatchNorm``)."""


class FlaxBatchNorm2d(_FlaxBatchNorm, nn.BatchNorm2d):
    """``(B, C, H, W)`` BatchNorm with flax's rule (``_FlaxBatchNorm``); the
    ResNet builds it with eps 1e-5, MobileNet with 1e-3."""


def flax_init_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Redraw every parameter of ``model`` in place, in module order, from
    ``generator`` (a CPU generator, whatever the model's device)."""

    def draw(t: torch.Tensor, fill) -> None:
        host = torch.empty(t.shape, dtype=torch.float32)
        fill(host)
        t.copy_(host)

    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (nn.Conv1d, nn.Conv2d, nn.Linear)):
                std = mod.weight[0].numel() ** -0.5 / _TRUNC_STD
                draw(mod.weight, lambda h: nn.init.trunc_normal_(
                    h, 0.0, std, -2.0 * std, 2.0 * std, generator=generator))
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.LSTM):
                b = mod.hidden_size**-0.5
                for p in mod.parameters():
                    draw(p, lambda h: h.uniform_(-b, b, generator=generator))
            elif isinstance(mod, (nn.modules.batchnorm._BatchNorm, nn.LayerNorm)):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
                if isinstance(mod, nn.modules.batchnorm._BatchNorm):
                    mod.reset_running_stats()
    return model
