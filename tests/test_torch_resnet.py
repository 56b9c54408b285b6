"""The port's ResNet family vs the JAX package's, on the CPU.

``AntiSpoofingResNet`` (forward, ``feature_maps`` / ``classify_features``),
``MoreFeaturesClassifier`` with its one shared extractor, 3 train steps of
each from the same converted weights (losses, parameters, BatchNorm running
statistics under flax's biased rule), the flax <-> torch round trips (the
shortcut parameters exist in ``block0`` alone, as in flax's tree), the
chained Adam optimizer state of the sweep, the 2-D layers (flax's
BatchNorm2d rule, channel dropout, ``flax_init_`` on grouped convolutions),
and a port checkpoint restored by the JAX package.

The JAX trunk builds its blocks with dropout 0.5 and the extractor
hard-codes 0.5, with no argument to turn them off; the train-step parity
runs the JAX side on test-local twins whose dropouts are 0 (same parameter
names) and sets the port's ``Dropout`` rates to 0 in place.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn
from flax import serialization

from audioanalysisdetector_tpu.models import resnet as jresnet
from audioanalysisdetector_tpu.train import checkpoint as jckpt
from audioanalysisdetector_tpu.train import losses as jlosses
from audioanalysisdetector_tpu.train.state import TrainState as JTrainState
from audioanalysisdetector_tpu.train.steps import make_train_step as j_make_train_step
from audioanalysisdetector_tpu_torch import convert
from audioanalysisdetector_tpu_torch.models.layers import (
    ChannelDropout,
    Dropout,
    FlaxBatchNorm2d,
    flax_init_,
)
from audioanalysisdetector_tpu_torch.models.resnet import AntiSpoofingResNet, MoreFeaturesClassifier
from audioanalysisdetector_tpu_torch.train import checkpoint, losses
from audioanalysisdetector_tpu_torch.train.state import TrainState
from audioanalysisdetector_tpu_torch.train.steps import make_train_step

torch.set_num_threads(2)

# eval forward, fp32 convolutions (oneDNN against XLA) summed in other
# orders through 13 conv + BN layers: logits of size ~10-40, relative
FWD_RTOL = 1e-5
# 3 Adam steps (lr 1e-3) of fp32 chains summed in other orders: losses
# within 2e-5; parameters within 5e-5, 5% of one Adam step: Adam moves each
# entry by about lr whatever its gradient's size, so an entry whose gradient
# is near its rounding noise steps by a ratio that rounds otherwise (one fc1
# entry of 24576 read 3.1e-5); BatchNorm statistics relative to their
# largest entry (the flax-rule variance E[x^2] - E[x]^2 loses ~1e-6 to
# cancellation; 2.6e-6 read)
LOSS_TOL = 2e-5
PARAM_TOL = 5e-5
BN_RTOL = 5e-5
LR = 1e-3
STEPS = 3
# block0's shortcut BatchNorm shift adds a per-channel constant to the input
# of the training-mode bn2, which removes it: its gradient is zero in exact
# arithmetic, and each package steps it by Adam-normalised rounding noise,
# up to lr a step each way, so it is held to 2 lr times the number of steps;
# bn2's running mean takes 0.1 of that shift at each forward (once per input
# of the shared extractor): after the k-th update up to 0.1 * 2 lr * k
NULL_GRAD = "shortcut_bn/bias"
NULL_GRAD_STAT = "block0/bn2/mean"
B = 4
SHAPES = ((16, 12), (8, 9), (10, 10))  # the three feature maps (H, W)


class _Trunk0(jresnet.ResNetTrunk):
    """The JAX trunk with its blocks' dropout at 0 (same names)."""

    def setup(self):
        self.stem_conv = nn.Conv(self.features, (3, 3), padding=1, use_bias=False)
        self.stem_bn = nn.BatchNorm(momentum=0.9, epsilon=1e-5)
        self.blocks = [jresnet.ResidualBlock(self.features, stride=s, dropout=0.0, name=f"block{i}")
                       for i, s in enumerate((3, 1, 1, 1, 1, 1))]


class _ResNet0(jresnet.AntiSpoofingResNet):
    def setup(self):
        self.trunk = _Trunk0()
        self.fc1 = nn.Dense(256)
        self.drop = nn.Dropout(0.0)
        self.fc2 = nn.Dense(self.num_classes)


class _Extractor0(jresnet.ExtractFeatureResidual):
    def setup(self):
        self.trunk = _Trunk0()
        self.fc1 = nn.Dense(256)
        self.drop = nn.Dropout(0.0)
        self.fc2 = nn.Dense(64)


class _MoreFeatures0(jresnet.MoreFeaturesClassifier):
    def setup(self):
        self.extractor = _Extractor0()
        self.fc1 = nn.Dense(128)
        self.drop1 = nn.Dropout(0.0)
        self.fc2 = nn.Dense(256)
        self.drop2 = nn.Dropout(0.0)
        self.fc3 = nn.Dense(self.num_classes)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, serialization.to_state_dict(tree))


def _inputs(kind: str, seed: int = 0):
    rng = np.random.default_rng(seed)
    n = 1 if kind == "resnet" else 3
    return tuple(rng.standard_normal((B, *SHAPES[i])).astype(np.float32) for i in range(n))


def _port(kind: str, variables: dict, *, no_dropout: bool = False):
    model = AntiSpoofingResNet() if kind == "resnet" else MoreFeaturesClassifier()
    model.load_state_dict(convert.flax_to_torch_resnet(variables))
    if no_dropout:
        for m in model.modules():
            if isinstance(m, Dropout):
                m.rate = 0.0
    return model


def _random(kind: str, seed: int) -> dict:
    return convert.random_flax_resnet(seed) if kind == "resnet" else convert.random_flax_more_features(seed)


def _init_tree(kind: str) -> dict:
    jm = jresnet.AntiSpoofingResNet() if kind == "resnet" else jresnet.MoreFeaturesClassifier()
    return _np(jm.init(jax.random.PRNGKey(0), *(jnp.asarray(x) for x in _inputs(kind)), train=False))


def _keys(tree, prefix=()):
    if isinstance(tree, dict):
        return {k for name, v in tree.items() for k in _keys(v, (*prefix, name))}
    return {"/".join(prefix) + f" {np.shape(tree)}"}


@pytest.mark.parametrize("kind", ["resnet", "more_features"])
def test_forward_matches_jax(kind):
    v = _random(kind, 1)
    xs = _inputs(kind)
    jm = jresnet.AntiSpoofingResNet() if kind == "resnet" else jresnet.MoreFeaturesClassifier()
    ref = np.asarray(jm.apply(v, *(jnp.asarray(x) for x in xs), train=False))
    got = _port(kind, v).eval()(*(torch.from_numpy(x) for x in xs)).detach().numpy()
    assert got.shape == ref.shape == (B, 2)
    np.testing.assert_allclose(got, ref, rtol=FWD_RTOL, atol=FWD_RTOL * np.abs(ref).max())


def test_channel_last_inputs_and_feature_maps_match_jax():
    """A 4-D channel-last input equals the 3-D one; ``feature_maps`` is
    ``(B, H', W', 32)`` as in JAX (64 x 63 -> 22 x 21: the stride-3 block),
    and ``classify_features`` resumes the forward from it."""
    v = convert.random_flax_resnet(2)
    x = np.random.default_rng(3).standard_normal((2, 64, 63)).astype(np.float32)
    model = _port("resnet", v).eval()
    jm = jresnet.AntiSpoofingResNet()
    fmap = model.feature_maps(torch.from_numpy(x))
    ref = np.asarray(jm.apply(v, jnp.asarray(x), method="feature_maps"))
    assert fmap.shape == ref.shape == (2, 22, 21, 32)
    np.testing.assert_allclose(fmap.detach().numpy(), ref, rtol=FWD_RTOL, atol=FWD_RTOL * np.abs(ref).max())
    logits = model.classify_features(fmap).detach().numpy()
    jlog = np.asarray(jm.apply(v, jnp.asarray(ref), method="classify_features"))
    np.testing.assert_allclose(logits, jlog, rtol=FWD_RTOL, atol=FWD_RTOL * np.abs(jlog).max())
    np.testing.assert_allclose(logits, model(torch.from_numpy(x)).detach().numpy(), rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(model(torch.from_numpy(x[..., None])), model(torch.from_numpy(x)))


@pytest.mark.parametrize("kind", ["resnet", "more_features"])
def test_train_steps_match_jax(kind):
    """3 CrossEntropy steps (Adam 1e-3) from one converted init, dropout 0:
    losses, parameters and every BatchNorm's running statistics (the shared
    extractor's move three times a step, once per input, in both)."""
    v = _random(kind, 4)
    model = _port(kind, v, no_dropout=True)
    state = TrainState.create(model=model, tx=lambda p: torch.optim.Adam(p, lr=LR))
    jm = _ResNet0() if kind == "resnet" else _MoreFeatures0()
    jstate = JTrainState.create(apply_fn=jm.apply, params=v["params"], tx=optax.adam(LR), batch_stats=v["batch_stats"])
    step = make_train_step(losses.get_loss("CrossEntropyLoss"))
    jstep = jax.jit(j_make_train_step(jlosses.get_loss("CrossEntropyLoss")))
    g = torch.Generator().manual_seed(0)
    ours, ref = [], []
    for i in range(STEPS):
        xs = _inputs(kind, seed=10 + i)
        y = np.random.default_rng(20 + i).integers(0, 2, B)
        tx = tuple(torch.from_numpy(x) for x in xs)
        state, m = step(state, tx if len(tx) > 1 else tx[0], torch.from_numpy(y), g)
        jx = tuple(jnp.asarray(x) for x in xs)
        jstate, jmet = jstep(jstate, jx if len(jx) > 1 else jx[0], jnp.asarray(y), jax.random.PRNGKey(0))
        ours.append(float(m["loss"]))
        ref.append(float(jmet["loss"]))
    np.testing.assert_allclose(ours, ref, rtol=LOSS_TOL, atol=LOSS_TOL)
    got = convert.torch_to_flax_resnet(state.model.state_dict())
    jp, jb = _np(jstate.params), _np(jstate.batch_stats)
    for path, a in jax.tree_util.tree_leaves_with_path(got["params"]):
        b = _leaf(jp, path)
        if "/".join(k.key for k in path).endswith(NULL_GRAD):
            assert np.abs(a - b).max() <= 2 * LR * STEPS, path
        else:
            np.testing.assert_allclose(a, b, rtol=PARAM_TOL, atol=PARAM_TOL, err_msg=str(path))
    n_inputs = 1 if kind == "resnet" else 3
    drift = 0.1 * 2 * LR * n_inputs * sum(range(STEPS))
    for path, a in jax.tree_util.tree_leaves_with_path(got["batch_stats"]):
        b = _leaf(jb, path)
        if "/".join(k.key for k in path).endswith(NULL_GRAD_STAT):
            assert np.abs(a - b).max() <= drift, path
        else:
            np.testing.assert_allclose(a, b, rtol=BN_RTOL, atol=BN_RTOL * np.abs(b).max(), err_msg=str(path))
    assert state.step == int(jstate.step) == STEPS


def _leaf(tree: dict, path) -> np.ndarray:
    for k in path:
        tree = tree[k.key]
    return tree


@pytest.mark.parametrize("kind", ["resnet", "more_features"])
def test_flax_round_trip_follows_the_init_tree(kind):
    """flax -> torch -> flax is exact, and the port's tree has the keys and
    shapes of JAX ``model.init``'s: ``shortcut_conv`` / ``shortcut_bn`` in
    ``block0`` only."""
    v = _random(kind, 5)
    back = convert.torch_to_flax_resnet(_port(kind, v).state_dict())
    for part in ("params", "batch_stats"):
        assert _keys(back[part]) == _keys(v[part])
        for path, a in jax.tree_util.tree_leaves_with_path(back[part]):
            np.testing.assert_array_equal(a, _leaf(v[part], path))
    init = _init_tree(kind)
    assert _keys(v["params"]) == _keys(init["params"])
    assert _keys(v["batch_stats"]) == _keys(init["batch_stats"])
    shortcut = {k.split(" ")[0] for k in _keys(v["params"]) if "shortcut" in k}
    assert shortcut and all("/block0/shortcut_" in k for k in shortcut)
    sd = AntiSpoofingResNet().state_dict()
    assert sd["trunk.block0.shortcut_conv.weight"].shape == (32, 32, 1, 1)
    assert not any("shortcut" in k for k in sd if ".block0." not in k)


@pytest.mark.parametrize("weight_decay", [0.0, 1e-5])
def test_adam_opt_state_layout_matches_optax(weight_decay):
    """Torch Adam with ``weight_decay`` > 0 (L2 in the gradient) is optax's
    ``chain(add_decayed_weights(wd), adam(lr))``: after 3 steps on the same
    gradients the port writes that chain's ``opt_state`` layout and numbers,
    and reads it back; with no decay, plain Adam's."""
    v = convert.random_flax_resnet(6)
    model = _port("resnet", v)
    opt = torch.optim.Adam(model.parameters(), lr=LR, weight_decay=weight_decay)
    tx = optax.chain(optax.add_decayed_weights(weight_decay), optax.adam(LR)) if weight_decay else optax.adam(LR)
    params = jax.tree_util.tree_map(jnp.asarray, v["params"])
    jst = tx.init(params)
    rng = np.random.default_rng(7)
    for _ in range(3):
        grads = jax.tree_util.tree_map(lambda a: rng.standard_normal(a.shape).astype(np.float32), v["params"])
        sd = convert.flax_to_torch_resnet({"params": grads})
        for name, p in model.named_parameters():
            p.grad = sd[name]
        opt.step()
        upd, jst = tx.update(jax.tree_util.tree_map(jnp.asarray, grads), jst, params)
        params = optax.apply_updates(params, upd)
    ours = convert.torch_to_flax_opt_state(opt, model)
    ref = _np(jst)
    assert _keys(ours) == _keys(ref)
    for path, a in jax.tree_util.tree_leaves_with_path(ref):
        np.testing.assert_allclose(_leaf(ours, path), a, rtol=1e-5, atol=1e-7, err_msg=str(path))
    fresh = _port("resnet", v)
    again = torch.optim.Adam(fresh.parameters(), lr=LR, weight_decay=weight_decay)
    convert.flax_to_torch_opt_state(ours, again, fresh)
    back = convert.torch_to_flax_opt_state(again, fresh)
    for path, a in jax.tree_util.tree_leaves_with_path(ours):
        np.testing.assert_array_equal(_leaf(back, path), a)


def test_port_checkpoint_restores_in_jax(tmp_path):
    """A port ``MoreFeaturesClassifier`` checkpoint after one step with the
    chained Adam restores into the JAX package's template state (its
    ``from_bytes`` demands the template's exact tree) and scores equal."""
    v = convert.random_flax_more_features(8)
    model = _port("more_features", v, no_dropout=True)
    state = TrainState.create(model=model, tx=lambda p: torch.optim.Adam(p, lr=LR, weight_decay=1e-5))
    xs = tuple(torch.from_numpy(x) for x in _inputs("more_features", 9))
    state, _ = make_train_step(losses.get_loss("CrossEntropyLoss"))(state, xs, torch.tensor([0, 1, 1, 0]),
                                                                      torch.Generator())
    path = tmp_path / "m.msgpack"
    checkpoint.save_checkpoint(str(path), state)
    jm = jresnet.MoreFeaturesClassifier()
    template = JTrainState.create(apply_fn=jm.apply, params=_init_tree("more_features")["params"],
                                  tx=optax.chain(optax.add_decayed_weights(1e-5), optax.adam(LR)),
                                  batch_stats=_init_tree("more_features")["batch_stats"])
    restored = jckpt.restore_checkpoint(str(path), template)
    assert int(restored.step) == 1
    ref = np.asarray(jm.apply({"params": restored.params, "batch_stats": restored.batch_stats},
                              *(jnp.asarray(x.numpy()) for x in xs), train=False))
    got = state.model.eval()(*xs).detach().numpy()
    np.testing.assert_allclose(got, ref, rtol=FWD_RTOL, atol=FWD_RTOL * np.abs(ref).max())


def test_flax_batchnorm2d_rule_and_eps():
    """Training mode moves the running statistics by 0.1 toward the batch
    mean and the BIASED variance over (B, H, W); eval normalizes with them
    and the constructor's eps, as flax's BatchNorm does (eps 1e-3 here)."""
    x = np.random.default_rng(1).standard_normal((3, 4, 5, 6)).astype(np.float32) * 2 + 1
    bn = FlaxBatchNorm2d(4, eps=1e-3, momentum=0.1)
    bn.train()(torch.from_numpy(x))
    jbn = nn.BatchNorm(momentum=0.9, epsilon=1e-3)
    xl = jnp.asarray(x.transpose(0, 2, 3, 1))
    jv = jbn.init(jax.random.PRNGKey(0), xl, use_running_average=False)
    _, upd = jbn.apply(jv, xl, use_running_average=False, mutable=["batch_stats"])
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(upd["batch_stats"]["mean"]), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(upd["batch_stats"]["var"]), rtol=1e-6)
    out = bn.eval()(torch.from_numpy(x)).detach().numpy()
    ref = np.asarray(jbn.apply({"params": jv["params"], "batch_stats": upd["batch_stats"]}, xl,
                               use_running_average=True)).transpose(0, 3, 1, 2)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)


def test_channel_dropout_masks_whole_channels():
    """One mask entry per (sample, channel), from the generator handed in:
    each (b, c) map is all kept (scaled by 2) or all zero."""
    drop = ChannelDropout(0.5).train()
    x = torch.ones(8, 16, 5, 7)
    out = drop(x, torch.Generator().manual_seed(0))
    per_map = out.reshape(8, 16, -1)
    assert set(per_map.unique().tolist()) == {0.0, 2.0}
    assert bool((per_map.amin(-1) == per_map.amax(-1)).all())
    torch.testing.assert_close(drop(x, torch.Generator().manual_seed(0)), out)
    with pytest.raises(ValueError, match="Generator"):
        drop(x)


def test_flax_init_conv2d_fan_in_with_groups():
    """``flax_init_`` draws conv kernels with flax's lecun_normal fan-in,
    ``kh * kw * in / groups`` (a depthwise 3x3 has 9): the truncated normal's
    bound is 2 std, reached to within a few percent on 2304+ entries."""
    convs = torch.nn.Sequential(torch.nn.Conv2d(32, 64, 3, bias=False),
                                torch.nn.Conv2d(256, 256, 3, groups=256, bias=False),
                                FlaxBatchNorm2d(8))
    convs[2].running_mean.fill_(3.0)
    flax_init_(convs, torch.Generator().manual_seed(0))
    for conv, fan_in in ((convs[0], 288), (convs[1], 9)):
        std = fan_in**-0.5 / 0.87962566103423978
        w = conv.weight.detach()
        assert float(w.abs().max()) <= 2 * std * (1 + 1e-6)
        assert abs(float(w.std()) / (fan_in**-0.5) - 1) < 0.1
    assert float(convs[2].running_mean.abs().max()) == 0.0
