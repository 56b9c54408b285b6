"""Train and eval steps (PyTorch).

Counterpart of the JAX package's ``train/steps.py``: a step is forward,
backward, optimizer update and metrics on the model's device. The model and
its optimizer are updated in place (``TrainState``), and the dropout masks
come from the ``torch.Generator`` the caller hands in. Both ``make_*`` turn
TF32 off for the process (``score.fused.ieee_fp32``): cuDNN's convolution
backward would otherwise run in TF32.

Data parallelism (``make_dp_train_step``, ``shard_batch``, ``replicate``):
the parameters are replicated over the ranks of a mesh axis (one process
and one device each, ``parallel/mesh.py``), each rank steps on its rows of
the global batch, and the gradients, the metrics and the BatchNorm running
statistics are averaged over the axis (``pmean`` in the JAX package) before
each rank applies the same update. The JAX step folds the axis index into
its dropout key; a ``torch.Generator`` has no fold-in, so each rank hands in
its own (``fit`` seeds it from (seed, rank)) and parity runs use dropout 0.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from audioanalysisdetector_tpu_torch.parallel.mesh import axis_group, axis_groups
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


def _pmean_(tensors: list[torch.Tensor], group) -> None:
    """Average ``tensors`` in place over the ranks of ``group``: one flat
    all-reduce (``pmean`` of a pytree)."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    flat /= dist.get_world_size(group)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset : offset + t.numel()].view_as(t))
        offset += t.numel()


def make_train_step(
    loss_fn: Callable,
    *,
    axis_name: str | None = None,
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

    With ``axis_name`` the step runs on this rank's rows and averages the
    gradients, the metrics and the BatchNorm running statistics over the
    process group bound to that name (``parallel.mesh.axis_groups``; the
    JAX step runs inside ``shard_map``)."""
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
            loss = loss.detach()
            if axis_name is not None:
                group = axis_group(axis_name)
                grads = [p.grad for p in model.parameters() if p.grad is not None]
                metrics = torch.stack([loss, acc])
                stats = [
                    b for m in model.modules() if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)
                    for b in (m.running_mean, m.running_var)
                ] if has_batch_stats else []
                _pmean_(grads + [metrics] + stats, group)
                loss, acc = metrics[0], metrics[1]
        state.apply_gradients()
        return state, {"loss": loss, "accuracy": acc}

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


def make_dp_train_step(
    loss_fn: Callable,
    mesh,
    *,
    axis: str = "data",
    has_batch_stats: bool = True,
    binary_head: bool = False,
    donate: bool = True,
) -> Callable:
    """Data-parallel ``step(state, x, y, generator) -> (state, metrics)``
    over the ``axis`` ranks of ``mesh`` (a ``DeviceMesh``): ``x`` and ``y``
    are this rank's rows of the global batch (``shard_batch``), the state
    is replicated (``replicate``), and the step binds the axis's process
    group for the averages and for a sync-BN model built with
    ``bn_axis_name=axis``. ``donate`` is accepted for the JAX signature: the
    state is always updated in place (``TrainState.copy`` keeps one)."""
    del donate
    inner = make_train_step(
        loss_fn, axis_name=axis, has_batch_stats=has_batch_stats, binary_head=binary_head
    )
    group = mesh.get_group(axis)

    def step(state: TrainState, x, y: torch.Tensor, generator: torch.Generator):
        with axis_groups({axis: group}):
            return inner(state, x, y, generator)

    return step


def shard_batch(batch, mesh, *, axis: str = "data"):
    """This rank's contiguous rows of a global batch (an array, a tensor, or
    a tuple of them), left where they lie: rank i of an n-rank axis takes
    rows ``[i * B / n, (i + 1) * B / n)``, the JAX package's row sharding."""
    n, i = mesh[axis].size(), mesh.get_local_rank(axis)

    def take(a):
        if isinstance(a, tuple):
            return tuple(take(ai) for ai in a)
        if len(a) % n:
            raise ValueError(f"global batch {len(a)} not divisible by {n} devices")
        per = len(a) // n
        return a[i * per : (i + 1) * per]

    return take(batch)


@torch.no_grad()
def replicate(tree: TrainState, mesh) -> TrainState:
    """The same state on every rank of ``mesh``: its model's parameters and
    buffers broadcast in place from the mesh's first rank (the optimizer
    state is the caller's: fresh, or restored from one checkpoint on every
    rank). Returns ``tree``."""
    src = int(mesh.mesh.flatten()[0])
    for t in tree.model.state_dict().values():
        dist.broadcast(t, src=src)
    return tree
