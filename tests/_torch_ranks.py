"""Spawned ``torch.distributed`` ranks for the port's multi-process tests.

Gloo ranks on the CPU, one process each, meeting through a file under the
test's ``tmp_path`` (no TCP port, so parallel test workers never collide).
This module imports nothing of jax: the rank functions run the port only,
and the test process holds their results against the JAX package. Each
rank function takes ``(rank, world, *args)`` and returns a picklable
result; ``run_ranks`` returns them in rank order.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import time

import numpy as np


def _rank_main(fn, rank: int, world: int, init_method: str, out_dir: str, args: tuple) -> None:
    import torch
    import torch.distributed as dist

    from audioanalysisdetector_tpu_torch.parallel.mesh import initialize_distributed

    torch.set_num_threads(1)
    initialize_distributed(init_method, world, rank, device="cpu")
    try:
        result = fn(rank, world, *args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def run_ranks(fn, world: int, tmp_path, *args, timeout: float = 240.0) -> list:
    """``fn`` on ``world`` gloo ranks; every rank joined within ``timeout``
    seconds or all are stopped and the test fails."""
    ctx = mp.get_context("spawn")
    init_method = f"file://{tmp_path}/rendezvous"
    procs = [
        ctx.Process(target=_rank_main, args=(fn, r, world, init_method, str(tmp_path), args))
        for r in range(world)
    ]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 0.0))
            if p.exitcode not in (None, 0):
                break  # the others may wait in a collective for it
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
            p.join(timeout=10.0)
    codes = [p.exitcode for p in procs]
    assert codes == [0] * world, f"ranks exited with {codes}"
    out = []
    for r in range(world):
        with open(tmp_path / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


# ------------------------------------------------------------ rank functions

T, F = 9, 16  # CNN-BiLSTM frames (conv channels) and mel bins


def _variables_of(model) -> dict:
    """The model's flax-layout variables, copied out of its tensors."""
    from audioanalysisdetector_tpu_torch.convert import torch_to_flax_cnn_bilstm

    def copy(tree):
        return {k: copy(v) for k, v in tree.items()} if isinstance(tree, dict) else np.array(tree)

    return copy(torch_to_flax_cnn_bilstm(model.state_dict()))


def _cnn_state(variables: dict, bn_axis_name: str | None, optimizer: tuple = ("Adam", 1e-3)):
    from audioanalysisdetector_tpu_torch.convert import flax_to_torch_cnn_bilstm
    from audioanalysisdetector_tpu_torch.models.cnn_bilstm import CNNBiLSTMHybrid
    from audioanalysisdetector_tpu_torch.train import TrainState, make_optimizer

    model = CNNBiLSTMHybrid(T, fixed_attention=True, logits=True, dropout_rate=0.0, conv_dropout=0.0,
                            bn_axis_name=bn_axis_name)
    model.load_state_dict(flax_to_torch_cnn_bilstm(variables))
    return TrainState.create(model=model, tx=make_optimizer(*optimizer))


def dp_training(rank: int, world: int, variables: dict, batches: list, fit_data: tuple, ckpt_dir: str,
                sgd: tuple) -> dict:
    """The data-parallel step over ``batches`` (global), one step of it
    with the ``sgd`` optimizer (name, lr), a DCP round trip of its state,
    ``fit(data_parallel=True)`` on ``fit_data`` and
    ``batch_iter(across_processes=True)``."""
    import torch

    from audioanalysisdetector_tpu_torch.parallel.mesh import local_batch_size, make_mesh, make_mesh_2d, process_shard
    from audioanalysisdetector_tpu_torch.train import get_loss
    from audioanalysisdetector_tpu_torch.train.checkpoint import restore_checkpoint_orbax, save_checkpoint_orbax
    from audioanalysisdetector_tpu_torch.train.loop import batch_iter, fit
    from audioanalysisdetector_tpu_torch.train.steps import make_dp_train_step, replicate, shard_batch

    mesh = make_mesh(world)
    errors = {}
    for name, call in (("process_shard", lambda: process_shard(7)),
                       ("local_batch_size", lambda: local_batch_size(7, mesh)),
                       ("make_mesh", lambda: make_mesh(world + 1)),
                       ("make_mesh_2d", lambda: make_mesh_2d(world, 2))):
        try:
            call()
        except ValueError as e:
            errors[name] = str(e)
    shard = process_shard(10)
    state = replicate(_cnn_state(variables, "data"), mesh)
    step = make_dp_train_step(get_loss("BCELoss"), mesh, binary_head=True, donate=False)
    generator = torch.Generator().manual_seed(rank)
    losses = []
    for x, y in batches:
        xl, yl = shard_batch((torch.from_numpy(x), torch.from_numpy(y)), mesh)
        state, m = step(state, xl, yl, generator)
        losses.append(float(m["loss"]))
    out = {"losses": losses, "variables": _variables_of(state.model),
           "errors": errors, "shards": (shard.start, shard.stop, local_batch_size(10, mesh))}

    sgd_state = replicate(_cnn_state(variables, "data", sgd), mesh)
    x, y = batches[0]
    xl, yl = shard_batch((torch.from_numpy(x), torch.from_numpy(y)), mesh)
    sgd_state, m = step(sgd_state, xl, yl, generator)
    out["sgd"] = {"loss": float(m["loss"]), "variables": _variables_of(sgd_state.model)}

    path = save_checkpoint_orbax(ckpt_dir, state)
    restored = restore_checkpoint_orbax(path, _cnn_state(variables, "data"))
    x, y = batches[0]
    xl, yl = shard_batch((torch.from_numpy(x), torch.from_numpy(y)), mesh)
    step(state, xl, yl, generator)
    step(restored, xl, yl, generator)  # the restored optimizer continues as the live one
    out["ckpt"] = {
        "path": path,
        "step": (restored.step, state.step),
        "same_after_a_step": all(
            torch.equal(a, b) for a, b in zip(state.model.state_dict().values(), restored.model.state_dict().values())
        ),
    }

    res = fit(_cnn_state(variables, "data"), fit_data, fit_data, loss_name="BCELoss", num_epochs=2,
              batch_size=8, binary_head=True, plots=False, seed=3, data_parallel=True)
    out["fit"] = {
        "logs": [(r.train_loss, r.val_loss, r.train_acc) for r in res.logs],
        "variables": _variables_of(res.state.model),
        "best_aliases_live": res.best_state.model is res.state.model,
    }
    xs, ys = fit_data
    out["batch_iter"] = list(batch_iter(xs, ys, 8, shuffle=True, seed=5, across_processes=True))
    return out


def _gmm(d: dict):
    from audioanalysisdetector_tpu_torch.models.gmm import from_numpy

    return from_numpy(d, device="cpu")


def sharded_gmm(rank: int, world: int, g1: dict, g2: dict, x: np.ndarray, mask: np.ndarray,
                frames: np.ndarray, em_kw: dict) -> dict:
    """The component-sharded llr on the (1 x 2) and (2 x 1) meshes, and the
    frame-sharded EM (flat and chunked) and MAP (flat and chunked)."""
    import torch
    import torch.distributed as dist

    from audioanalysisdetector_tpu_torch.models.gmm import fit_em, map_adapt, map_adapt_chunked, to_numpy
    from audioanalysisdetector_tpu_torch.parallel.mesh import make_mesh_2d, process_shard
    from audioanalysisdetector_tpu_torch.parallel.sharded_gmm import make_mesh_2d_for, make_sharded_masked_llr
    from audioanalysisdetector_tpu_torch.train.steps import shard_batch

    out = {}
    for mesh in (make_mesh_2d_for(world, model=2), make_mesh_2d(2, 1)):
        xl, ml = shard_batch((torch.from_numpy(x), torch.from_numpy(mask)), mesh, axis="data")
        shape = tuple(mesh.mesh.shape)
        out[shape] = make_sharded_masked_llr(mesh, _gmm(g1), _gmm(g2))(xl, ml).numpy()

    group = dist.group.WORLD
    shard = frames[process_shard(len(frames))]
    ubm = fit_em(shard, device="cpu", group=group, **em_kw)
    out["em"] = to_numpy(ubm)
    out["em_chunked"] = to_numpy(fit_em(shard, device="cpu", group=group, chunk=500, flat_bytes=0, **em_kw))
    xs = torch.from_numpy(shard)
    w = torch.ones(len(shard))
    out["map"] = to_numpy(map_adapt(ubm, xs, frame_weights=w, group=group))
    out["map_chunked"] = to_numpy(map_adapt_chunked(ubm, xs, chunk=500, frame_weights=w, group=group))
    return out
