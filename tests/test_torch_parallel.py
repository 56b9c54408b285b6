"""The port's data parallelism on 2 gloo ranks vs the JAX package on 2 devices, on the CPU.

The ranks are spawned processes (``tests/_torch_ranks.py``); the JAX side
runs ``make_dp_train_step`` over ``make_mesh(2)`` of the conftest's virtual
CPU devices, on the same numpy batches and converted weights, every dropout
rate at 0 and sync-BN (``bn_axis_name="data"``) on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audioanalysisdetector_tpu.models.cnn_bilstm import CNNBiLSTMHybrid as JCNNBiLSTMHybrid
from audioanalysisdetector_tpu.parallel.mesh import local_batch_size as j_local_batch_size
from audioanalysisdetector_tpu.parallel.mesh import make_mesh as j_make_mesh
from audioanalysisdetector_tpu.parallel.mesh import process_shard as j_process_shard
from audioanalysisdetector_tpu.train import loop as jloop
from audioanalysisdetector_tpu.train.losses import get_loss as j_get_loss
from audioanalysisdetector_tpu.train.optimizers import make_optimizer as j_make_optimizer
from audioanalysisdetector_tpu.train.state import TrainState as JTrainState
from audioanalysisdetector_tpu.train.steps import make_dp_train_step as j_make_dp_train_step
from audioanalysisdetector_tpu_torch.convert import random_flax_cnn_bilstm, torch_to_flax_cnn_bilstm
from audioanalysisdetector_tpu_torch.entry import dryrun_multichip
from audioanalysisdetector_tpu_torch.parallel import mesh as tmesh
from audioanalysisdetector_tpu_torch.train.checkpoint import restore_checkpoint_orbax, save_checkpoint_orbax
from audioanalysisdetector_tpu_torch.train.loop import fit
from tests import _torch_ranks as R

torch.set_num_threads(2)

# three Adam steps (lr 1e-3) of the same global batches on two devices:
# losses, and parameters at the JAX package's own DP-vs-one-device bounds
# (tests/test_train.py:113-117); Adam's 1/sqrt(v) amplifies float noise on
# near-zero-gradient parameters, hence the atol
LOSS_RTOL = 1e-4
PARAM_RTOL, PARAM_ATOL = 1e-2, 1e-4
# the BatchNorm running statistics after them, relative to each array's
# largest entry: the flax rule's E[x^2] - E[x]^2 of conv outputs of inputs
# ~ -40 +- 10, the moments averaged over the ranks in fp32 (this data
# reads 3.6e-6 against JAX, 1.6e-6 for fit against one process)
BN_RTOL = 1e-4
N_STEPS, B = 3, 8
# one SGD step (momentum's first step is lr x the gradient): Adam's update
# does not move when the gradient is scaled, SGD's does, so a DP step that
# sums the ranks' gradients, or scales them by the world size, fails here.
# Each array's update against JAX's, relative to the largest update of all
# arrays (the arrays whose gradient is zero in exact arithmetic, the conv
# bias under the BatchNorm and the softmax attention's bias, move by
# rounding noise only); this data reads 1.1e-6, and a gradient doubled
# after the average reads 1.0
SGD = ("SGD", 0.1)
UPDATE_RTOL = 1e-4


def _batches():
    rng = np.random.default_rng(5)
    return [((rng.standard_normal((B, R.F, R.T)) * 10 - 40).astype(np.float32), rng.integers(0, 2, B))
            for _ in range(N_STEPS)]


def _fit_data():
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((20, R.F, R.T)) * 10 - 40).astype(np.float32)
    return x, rng.integers(0, 2, 20)


@pytest.fixture(scope="module")
def variables():
    return random_flax_cnn_bilstm(3, R.T, fixed_attention=True)


@pytest.fixture(scope="module")
def ranks(variables, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp")
    return R.run_ranks(R.dp_training, 2, tmp, variables, _batches(), _fit_data(), str(tmp / "ckpt"), SGD)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


def _assert_params_close(ours: dict, ref):
    o, r = _flat(ours), _flat(jax.tree_util.tree_map(np.asarray, ref))
    assert set(o) == set(r)
    for k in o:
        np.testing.assert_allclose(o[k], r[k], rtol=PARAM_RTOL, atol=PARAM_ATOL, err_msg=k)


def _assert_stats_close(ours: dict, ref: dict):
    for k in ("mean", "var"):
        want = np.asarray(ref["bn"][k])
        np.testing.assert_allclose(ours["bn"][k], want, rtol=0, atol=BN_RTOL * np.abs(want).max(), err_msg=k)


def test_process_shard_and_local_batch_size_contracts():
    assert tmesh.process_shard(100) == j_process_shard(100) == slice(0, 100)  # one process
    assert tmesh.process_count() == 1 and tmesh.process_index() == 0
    with pytest.raises(RuntimeError, match="initialize_distributed"):
        tmesh.make_mesh()
    mesh2 = j_make_mesh(2)
    assert j_local_batch_size(10, mesh2) == 5
    with pytest.raises(ValueError) as e:
        j_local_batch_size(7, mesh2)
    assert str(e.value) == "global batch 7 not divisible by 2 devices"
    tmesh.initialize_distributed()  # no arguments, no launcher: a no-op
    assert not torch.distributed.is_initialized()


def test_rank_contracts_match_jax_messages(ranks):
    """Inside the 2-rank group: the shards, the meshes' refusals and the
    messages of the JAX package's checks, word for word."""
    errors = [r["errors"] for r in ranks]
    assert errors[0] == errors[1]
    assert errors[0]["process_shard"] == "global batch of 7 rows not divisible by 2 processes"
    assert errors[0]["local_batch_size"] == "global batch 7 not divisible by 2 devices"
    assert errors[0]["make_mesh"] == "requested 3 devices, have 2"
    assert errors[0]["make_mesh_2d"] == "mesh 2x2 exceeds 2 devices"
    assert [r["shards"] for r in ranks] == [(0, 5, 5), (5, 10, 5)]


def test_dp_step_matches_jax_two_devices(ranks, variables):
    """Three sync-BN DP steps, 2 gloo ranks vs JAX's 2-device shard_map."""
    jmodel = JCNNBiLSTMHybrid(fixed_attention=True, logits=True, dropout_rate=0.0, conv_dropout=0.0,
                              bn_axis_name="data")
    jstate = JTrainState.create(apply_fn=jmodel.apply, params=variables["params"],
                                tx=j_make_optimizer("Adam", 1e-3), batch_stats=variables["batch_stats"])
    jstep = j_make_dp_train_step(j_get_loss("BCELoss"), j_make_mesh(2), binary_head=True, donate=False)
    jlosses = []
    for x, y in _batches():
        jstate, jm = jstep(jstate, jnp.asarray(x), jnp.asarray(y), jax.random.PRNGKey(0))
        jlosses.append(float(jm["loss"]))
    for r in ranks:
        np.testing.assert_allclose(r["losses"], jlosses, rtol=LOSS_RTOL)
        _assert_params_close(r["variables"]["params"], jstate.params)
        _assert_stats_close(r["variables"]["batch_stats"], jstate.batch_stats)
    # the ranks apply the same averaged update: their states stay equal
    a, b = (_flat(r["variables"]) for r in ranks)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_dp_sgd_update_matches_jax_two_devices(ranks, variables):
    """One SGD step of the 2-rank DP step against JAX's 2-device step: the
    averaged gradient's scale shows in the update."""
    jmodel = JCNNBiLSTMHybrid(fixed_attention=True, logits=True, dropout_rate=0.0, conv_dropout=0.0,
                              bn_axis_name="data")
    jstate = JTrainState.create(apply_fn=jmodel.apply, params=variables["params"],
                                tx=j_make_optimizer(*SGD), batch_stats=variables["batch_stats"])
    jstep = j_make_dp_train_step(j_get_loss("BCELoss"), j_make_mesh(2), binary_head=True, donate=False)
    x, y = _batches()[0]
    jstate, jm = jstep(jstate, jnp.asarray(x), jnp.asarray(y), jax.random.PRNGKey(0))
    init = _flat(jax.tree_util.tree_map(np.asarray, variables["params"]))
    want = {k: v - init[k] for k, v in _flat(jax.tree_util.tree_map(np.asarray, jstate.params)).items()}
    scale = max(float(np.abs(v).max()) for v in want.values())
    for r in ranks:
        np.testing.assert_allclose(r["sgd"]["loss"], float(jm["loss"]), rtol=LOSS_RTOL)
        got = {k: v - init[k] for k, v in _flat(r["sgd"]["variables"]["params"]).items()}
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=UPDATE_RTOL * scale, err_msg=k)
        _assert_stats_close(r["sgd"]["variables"]["batch_stats"], jstate.batch_stats)


def test_fit_data_parallel_matches_single_process(ranks, variables):
    """``fit(data_parallel=True)`` on 2 ranks (sync-BN) against the plain
    single-process ``fit`` on the same batches."""
    x, y = _fit_data()
    single = fit(R._cnn_state(variables, None), (x, y), (x, y), loss_name="BCELoss", num_epochs=2,
                 batch_size=8, binary_head=True, plots=False, seed=3, data_parallel=False)
    want = torch_to_flax_cnn_bilstm(single.state.model.state_dict())
    for r in ranks:
        got = r["fit"]
        np.testing.assert_allclose(
            np.asarray(got["logs"])[:, :2], [(g.train_loss, g.val_loss) for g in single.logs], rtol=LOSS_RTOL)
        _assert_params_close(got["variables"]["params"], want["params"])
        _assert_stats_close(got["variables"]["batch_stats"], want["batch_stats"])
        assert not got["best_aliases_live"]


def test_batch_iter_across_processes(ranks):
    """Each rank materializes its half of every global batch of the JAX
    package's permutation; the true count stays global."""
    x, y = _fit_data()
    ref = list(jloop.batch_iter(x, y, 8, shuffle=True, seed=5))
    for rank, r in enumerate(ranks):
        assert len(r["batch_iter"]) == len(ref)
        for (a, b, n), (c, d, m) in zip(r["batch_iter"], ref):
            np.testing.assert_array_equal(a, c[rank * 4:(rank + 1) * 4])
            np.testing.assert_array_equal(b, d[rank * 4:(rank + 1) * 4])
            assert n == m


def test_dcp_checkpoint_round_trip(ranks, variables, tmp_path):
    """``save_checkpoint_orbax`` / ``restore_checkpoint_orbax`` (DCP): on 2
    ranks the restored state steps as the live one; in one process, too."""
    for r in ranks:
        assert r["ckpt"]["path"].endswith(f"step_{N_STEPS}")
        assert r["ckpt"]["step"] == (N_STEPS + 1, N_STEPS + 1)
        assert r["ckpt"]["same_after_a_step"]
    state = R._cnn_state(variables, None)
    from audioanalysisdetector_tpu_torch.train import get_loss, make_train_step

    step = make_train_step(get_loss("BCELoss"), binary_head=True)
    x, y = _batches()[0]
    step(state, torch.from_numpy(x), torch.from_numpy(y), torch.Generator())
    path = save_checkpoint_orbax(str(tmp_path), state)
    restored = restore_checkpoint_orbax(path, R._cnn_state(variables, None))
    assert restored.step == 1
    for live in (state, restored):
        step(live, torch.from_numpy(x), torch.from_numpy(y), torch.Generator())
    for a, b in zip(state.model.state_dict().values(), restored.model.state_dict().values()):
        assert torch.equal(a, b)


def test_sync_bn_outside_a_mesh_raises_as_flax(variables):
    """A sync-BN model trains only where its axis is bound (flax raises the
    same outside ``shard_map``); evaluation needs no axis."""
    state = R._cnn_state(variables, "data")
    x = torch.from_numpy(_batches()[0][0])
    with pytest.raises(NameError, match="unbound axis name: data"):
        state.model.train()(x)
    assert state.model.eval()(x).shape == (B, 1)


def test_dryrun_multichip_two_gloo_ranks(capfd):
    dryrun_multichip(2, device="cpu")
    assert "dryrun_multichip OK: 2-rank DP mesh on cpu" in capfd.readouterr().out
    with pytest.raises(RuntimeError, match="need 2 CUDA devices"):
        dryrun_multichip(2)  # no card here: the card path refuses, no CPU fallback
