"""Process groups and device meshes — the port's parallelism substrate.

Counterpart of the JAX package's ``parallel/mesh.py``. A JAX mesh is the
devices of one process, addressed by axis names under ``shard_map``; a
torch mesh is processes, one device each, joined by ``torch.distributed``.
So here:

- ``initialize_distributed`` joins (or, with no arguments on a single
  process, skips) the process group: NCCL when the ranks own CUDA
  devices, gloo for CPU ranks;
- ``make_mesh`` / ``make_mesh_2d`` are ``init_device_mesh`` over every
  rank of that group: a mesh axis is a sub-group of ranks, the
  counterpart of a ``shard_map`` axis name;
- ``split_rows_over`` is the one-process counterpart of a per-row function
  over a batch sharded across the local devices: each card scores its
  share of the rows, with no collectives;
- ``process_shard`` is this rank's slice of a globally indexed dataset;
- ``axis_groups`` binds axis names to the process groups of a mesh while
  a step runs, as ``shard_map`` binds them in the JAX package, and
  ``all_reduce_sum`` is ``psum`` with its transpose (the gradient of a
  sum over ranks is the sum of the ranks' gradients).

A mesh spans every rank of the group: the JAX package's "first n devices"
of a larger host has no counterpart, and asking for another size raises.
"""

from __future__ import annotations

import contextlib
import contextvars
import os

import torch
import torch.distributed as dist

_AXIS_GROUPS: contextvars.ContextVar[dict] = contextvars.ContextVar("axis_groups", default={})


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    device: str = "cuda",
) -> None:
    """Join the process group (``torch.distributed.init_process_group``).

    ``coordinator_address`` is ``host:port`` (TCP) or any init URL
    (``tcp://...``, ``file://...``). With explicit arguments failures
    propagate; with none, a launcher's environment (``MASTER_ADDR``,
    ``WORLD_SIZE``, ``RANK``) is used when it is set, and otherwise this
    is a single process and nothing happens. ``device`` is what the rank
    computes on: ``"cuda"`` takes NCCL and card ``LOCAL_RANK`` (else
    ``process_id``) modulo the card count, ``"cpu"`` takes gloo."""
    if dist.is_initialized():
        return  # already joined by the launcher
    if coordinator_address is None:
        if not {"MASTER_ADDR", "WORLD_SIZE", "RANK"} <= set(os.environ):
            return  # single process
        init_method = "env://"
        num_processes = int(os.environ["WORLD_SIZE"]) if num_processes is None else num_processes
        process_id = int(os.environ["RANK"]) if process_id is None else process_id
    else:
        init_method = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    if num_processes is None or process_id is None:
        raise ValueError("num_processes and process_id are required with a coordinator_address")
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize_distributed(device='cuda'): no CUDA device is visible")
        local = int(os.environ.get("LOCAL_RANK", process_id))  # a launcher's rank on this host
        torch.cuda.set_device(local % torch.cuda.device_count())
    elif device != "cpu":
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    dist.init_process_group(
        "nccl" if device == "cuda" else "gloo",
        init_method=init_method,
        world_size=num_processes,
        rank=process_id,
    )


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _mesh_device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _check_initialized() -> int:
    if not dist.is_initialized():
        raise RuntimeError(
            "a torch mesh spans the ranks of a process group: call "
            "initialize_distributed (or init_process_group) first"
        )
    return dist.get_world_size()


def make_mesh(n_devices: int | None = None, *, axis: str = "data"):
    """1-D ``DeviceMesh`` over the ranks (default: all of them)."""
    world = _check_initialized()
    n = world if n_devices is None else n_devices
    if n > world:
        raise ValueError(f"requested {n} devices, have {world}")
    if n != world:
        raise ValueError(f"a mesh spans every rank: requested {n} of {world}")
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(_mesh_device_type(), (n,), mesh_dim_names=(axis,))


def make_mesh_2d(dp: int, mp: int, *, axes: tuple[str, str] = ("data", "model")):
    """(dp, mp) ``DeviceMesh``: rank r sits at (r // mp, r % mp)."""
    world = _check_initialized()
    if dp * mp > world:
        raise ValueError(f"mesh {dp}x{mp} exceeds {world} devices")
    if dp * mp != world:
        raise ValueError(f"a mesh spans every rank: mesh {dp}x{mp} of {world}")
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(_mesh_device_type(), (dp, mp), mesh_dim_names=axes)


def process_shard(n_items: int) -> slice:
    """This process's contiguous slice of a globally indexed dataset.

    Multi-process data loading: each rank decodes only its shard of every
    global batch. On a single process this is the identity slice."""
    p, n_p = process_index(), process_count()
    if n_items % n_p:
        # ceil-division would hand processes unequal (possibly empty)
        # slices, and the ranks' steps would then average unequal shards.
        # Fail with the contract named instead.
        raise ValueError(
            f"global batch of {n_items} rows not divisible by {n_p} processes"
        )
    per = n_items // n_p
    return slice(p * per, (p + 1) * per)


def local_batch_size(global_batch: int, mesh, *, axis: str = "data") -> int:
    n = mesh[axis].size()
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by {n} devices")
    return global_batch // n


def split_rows_over(devices: list[torch.device], fns: list, batch: torch.Tensor) -> torch.Tensor:
    """``fns[i]`` of the i-th even share of ``batch``'s rows on
    ``devices[i]``, concatenated on ``batch``'s device in row order. Every
    share is launched (on its card's current stream) before any result is
    read back. A batch whose rows do not divide over the devices raises."""
    if batch.shape[0] % len(devices):
        raise ValueError(f"batch rows {batch.shape[0]} not divisible by {len(devices)} local devices")
    outs = []
    for fn, part, d in zip(fns, batch.chunk(len(devices)), devices):
        with torch.cuda.device(d) if d.type == "cuda" else contextlib.nullcontext():
            outs.append(fn(part.to(d)))
    return torch.cat([o.to(batch.device) for o in outs])


@contextlib.contextmanager
def axis_groups(mapping: dict):
    """Bind axis names to process groups for the code inside (the layers
    that reduce over a named axis look their group up here)."""
    token = _AXIS_GROUPS.set({**_AXIS_GROUPS.get(), **mapping})
    try:
        yield
    finally:
        _AXIS_GROUPS.reset(token)


def axis_group(name: str):
    """The process group bound to ``name``; an unbound name raises as
    flax's does outside ``shard_map``."""
    groups = _AXIS_GROUPS.get()
    if name not in groups:
        raise NameError(f"unbound axis name: {name}")
    return groups[name]


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        out = grad.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=ctx.group)
        return out, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``psum``: the sum over the ranks of ``group``, differentiable (its
    gradient is the sum over the ranks of theirs, as ``psum``'s transpose)."""
    return _AllReduceSum.apply(x, group)
