"""The port's MobileNetV2 + MFCA vs the JAX package's, on the CPU.

The 2-D DCT pair (against JAX and as a round trip, the identity on the
(B, C, 1, 1) attention vector), ``MFCAModule`` with its thirds, the whole
model's forward and one train step from the same converted weights
(losses, parameters, BatchNorm statistics at eps 1e-3), the flax tree's
``nn.compact`` names and the parameter count, 2,757,906, as in JAX.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from audioanalysisdetector_tpu.models import mobilenet_mfca as jmob
from audioanalysisdetector_tpu.train import losses as jlosses
from audioanalysisdetector_tpu.train.state import TrainState as JTrainState
from audioanalysisdetector_tpu.train.steps import make_train_step as j_make_train_step
from audioanalysisdetector_tpu_torch import convert
from audioanalysisdetector_tpu_torch.models.mobilenet_mfca import (
    MFCAModule,
    MobileNetMFCA,
    MobileNetV2Features,
    dct_2d,
    idct_2d,
)
from audioanalysisdetector_tpu_torch.train import losses
from audioanalysisdetector_tpu_torch.train.state import TrainState, param_count
from audioanalysisdetector_tpu_torch.train.steps import make_train_step

torch.set_num_threads(2)

# the DCT pair: float32 products of float64-built bases, other orders
DCT_TOL = 1e-6
# eval forward through 52 fp32 conv + BN layers (oneDNN against XLA), logits
# relative to their largest: against a float64 run of the port the port's
# fp32 logits read 2.3e-5, JAX's jitted ones 1.3e-5, so 5e-5; MFCA alone
# (two Dense, sigmoid) absolute
FWD_RTOL = 5e-5
MFCA_TOL = 1e-6
# one SGD step (the sweep's: lr 1e-3, momentum 0.9), held to the JAX step
# run in float64 (``jax.enable_x64``): 52 training-mode BatchNorms compound
# rounding, and flax normalizes with E[x^2] - E[x]^2, which cancels in
# fp32, so JAX's own fp32 step strays from its float64 one by 2.6e-3 of the
# model's largest gradient (6.2e-5 of the largest logit), the port's fp32
# step by 3.6e-5 (1.4e-5); in float64 the two packages agree to 1e-15.
# Loss relative 1e-4; each parameter's update (lr times its gradient) within
# 2e-4 of the model's largest update; BatchNorm statistics relative to their
# largest entry. (An Adam step would also turn the gradients that are zero
# in exact arithmetic, such as every projection BatchNorm's shift, whose
# output reaches a training-mode BatchNorm through linear maps only, into
# steps of +-lr in either package; the chained Adam's numbers are held to
# optax in tests/test_torch_resnet.py.)
LOSS_TOL = 1e-4
UPDATE_TOL = 2e-4
BN_RTOL = 1e-4
LR, WD = 1e-3, 1e-5
# 64 x 64 maps end 2 x 2 after the five stride-2 stages: training-mode
# BatchNorm then averages over 16 values a channel at the last layers (at
# 32 x 32, over 4, both packages stray ~1e-3 from a float64 run)
B, H, W = 4, 64, 64


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, serialization.to_state_dict(tree))


def _leaf(tree: dict, path):
    for k in path:
        tree = tree[k.key]
    return tree


def _keys(tree, prefix=()):
    if isinstance(tree, dict):
        return {k for name, v in tree.items() for k in _keys(v, (*prefix, name))}
    return {"/".join(prefix) + f" {tuple(tree.shape)}"}


def _x(seed: int, shape=(B, H, W)) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_dct_2d_matches_jax_and_round_trips():
    x = _x(0, (2, 3, 8, 6))
    ours = dct_2d(torch.from_numpy(x))
    np.testing.assert_allclose(ours.numpy(), np.asarray(jmob.dct_2d(jnp.asarray(x))), rtol=DCT_TOL, atol=DCT_TOL)
    np.testing.assert_allclose(idct_2d(ours).numpy(), x, rtol=10 * DCT_TOL, atol=10 * DCT_TOL)
    y = torch.rand(4, 16, 1, 1, generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(idct_2d(dct_2d(y)), y, rtol=0, atol=1e-7)


def test_mfca_module_matches_jax():
    """Thirds of unequal widths (as 426/426/428 of 1280) through the SE with
    the DCT round trip: ``x * sigmoid(2 y)``."""
    rng = np.random.default_rng(2)
    parts = [rng.standard_normal((2, 4, 4, c)).astype(np.float32) for c in (10, 10, 12)]
    jm = jmob.MFCAModule()
    v = _np(jm.init(jax.random.PRNGKey(0), *(jnp.asarray(p) for p in parts)))
    m = MFCAModule(channels=32)
    m.load_state_dict(convert.flax_to_torch_mobilenet_mfca(v))
    got = m(*(torch.from_numpy(p.transpose(0, 3, 1, 2)) for p in parts)).detach().numpy().transpose(0, 2, 3, 1)
    ref = np.asarray(jm.apply(v, *(jnp.asarray(p) for p in parts)))
    np.testing.assert_allclose(got, ref, rtol=MFCA_TOL, atol=MFCA_TOL)
    x = np.concatenate(parts, -1)
    y = torch.sigmoid(m.Dense_1(torch.relu(m.Dense_0(torch.from_numpy(x.mean(axis=(1, 2)))))))
    np.testing.assert_allclose(got, x * torch.sigmoid(2 * y).detach().numpy()[:, None, None], rtol=1e-6, atol=1e-6)


def test_forward_matches_jax():
    v = convert.random_flax_mobilenet_mfca(3)
    m = MobileNetMFCA()
    m.load_state_dict(convert.flax_to_torch_mobilenet_mfca(v))
    x = _x(4)
    ref = np.asarray(jax.jit(lambda v, x: jmob.MobileNetMFCA().apply(v, x, train=False))(v, jnp.asarray(x)))
    got = m.eval()(torch.from_numpy(x)).detach().numpy()
    assert got.shape == ref.shape == (B, 2)
    np.testing.assert_allclose(got, ref, rtol=FWD_RTOL, atol=FWD_RTOL * np.abs(ref).max())
    torch.testing.assert_close(m(torch.from_numpy(x[..., None])), m(torch.from_numpy(x)))


def test_train_step_matches_jax():
    """One CrossEntropy step with the sweep's SGD from one converted init,
    dropout 0 (``MobileNetMFCA(dropout=0.0)`` in JAX, run in float64): loss,
    parameters, BatchNorm running statistics."""
    v = convert.random_flax_mobilenet_mfca(5)
    m = MobileNetMFCA(dropout=0.0)
    m.load_state_dict(convert.flax_to_torch_mobilenet_mfca(v))
    state = TrainState.create(model=m, tx=lambda p: torch.optim.SGD(p, lr=LR, momentum=0.9))
    x, y = _x(6), np.arange(B) % 2
    state, met = make_train_step(losses.get_loss("CrossEntropyLoss"))(
        state, torch.from_numpy(x), torch.from_numpy(y), torch.Generator())
    with jax.enable_x64(True):
        f64 = partial(jax.tree_util.tree_map, lambda a: jnp.asarray(a, jnp.float64))
        jstate = JTrainState.create(apply_fn=jmob.MobileNetMFCA(dropout=0.0).apply, params=f64(v["params"]),
                                    tx=optax.sgd(LR, momentum=0.9), batch_stats=f64(v["batch_stats"]))
        jstate, jmet = jax.jit(j_make_train_step(jlosses.get_loss("CrossEntropyLoss")))(
            jstate, jnp.asarray(x, jnp.float64), jnp.asarray(y), jax.random.PRNGKey(0))
        jp, jb, jopt, jloss = (_np(jstate.params), _np(jstate.batch_stats), _np(jstate.opt_state),
                               float(jmet["loss"]))
    np.testing.assert_allclose(float(met["loss"]), jloss, rtol=LOSS_TOL)
    got = convert.torch_to_flax_mobilenet_mfca(state.model.state_dict())
    leaves = jax.tree_util.tree_leaves_with_path(got["params"])
    largest = max(float(np.abs(_leaf(jp, path) - _leaf(v["params"], path)).max()) for path, _ in leaves)
    for path, a in leaves:
        p0 = _leaf(v["params"], path)
        np.testing.assert_allclose(a - p0, _leaf(jp, path) - p0, rtol=0, atol=UPDATE_TOL * largest, err_msg=str(path))
    for path, a in jax.tree_util.tree_leaves_with_path(got["batch_stats"]):
        b = _leaf(jb, path)
        np.testing.assert_allclose(a, b, rtol=BN_RTOL, atol=BN_RTOL * np.abs(b).max(), err_msg=str(path))
    assert _keys(convert.torch_to_flax_opt_state(state.optimizer, state.model)) == _keys(jopt)


def test_chained_adam_state_has_the_optax_tree():
    """The MFCA driver's ``Adam(weight_decay)`` writes the tree of optax's
    ``chain(add_decayed_weights, adam)`` state over MobileNet's parameters."""
    v = convert.random_flax_mobilenet_mfca(7)
    m = MobileNetMFCA()
    m.load_state_dict(convert.flax_to_torch_mobilenet_mfca(v))
    state = TrainState.create(model=m, tx=lambda p: torch.optim.Adam(p, lr=LR, weight_decay=WD))
    state, _ = make_train_step(losses.get_loss("CrossEntropyLoss"))(
        state, torch.from_numpy(_x(8)), torch.tensor([1, 0, 0, 1]), torch.Generator().manual_seed(0))
    tx = optax.chain(optax.add_decayed_weights(WD), optax.adam(LR))
    ref = serialization.to_state_dict(jax.eval_shape(lambda: tx.init(v["params"])))
    opt = convert.torch_to_flax_opt_state(state.optimizer, state.model)
    assert _keys(opt) == _keys(ref)
    assert int(opt["1"]["0"]["count"]) == 1


@pytest.mark.parametrize("part", ["model", "features"])
def test_tree_names_and_parameter_count_match_jax(part):
    """The port's flax tree has the keys and shapes of JAX ``model.init``'s
    (``nn.compact`` auto-names); the model counts 2,757,906 parameters, its
    trunk 2,223,296 (the published MobileNetV2 features with a 1-channel
    stem, ``tests/test_mobilenet_eda.py``)."""
    if part == "model":
        ours, jm, x, count = MobileNetMFCA(), jmob.MobileNetMFCA(), jnp.zeros((1, 32, 32)), 2_757_906
    else:
        ours, jm, x, count = MobileNetV2Features(), jmob.MobileNetV2Features(), jnp.zeros((1, 32, 32, 1)), 2_223_296
    init = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), x, train=False))
    tree = convert.torch_to_flax_mobilenet_mfca(ours.state_dict())
    for collection in ("params", "batch_stats"):
        assert _keys(tree[collection]) == _keys(init[collection])
    assert param_count(ours) == count
    back = convert.flax_to_torch_mobilenet_mfca(tree)
    for k, t in ours.state_dict().items():
        torch.testing.assert_close(back[k], t, rtol=0, atol=0)
