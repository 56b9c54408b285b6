"""The port's training pieces vs the JAX package's, on the CPU.

Losses (both zoos), the four optimizers against optax, the flax-like
initialiser, ``make_train_step`` / ``make_eval_step`` of both models from
the same converted init with every dropout rate at 0, BatchNorm running
statistics under flax's biased rule, the tensor EER, and seeded dropout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from audioanalysisdetector_tpu.models.bilstm_classifier import BiLSTMClassifier as JBiLSTMClassifier
from audioanalysisdetector_tpu.models.cnn_bilstm import CNNBiLSTMHybrid as JCNNBiLSTMHybrid
from audioanalysisdetector_tpu.train import losses as jlosses
from audioanalysisdetector_tpu.train.metrics import eer_jnp
from audioanalysisdetector_tpu.train.optimizers import make_optimizer as j_make_optimizer
from audioanalysisdetector_tpu.train.state import TrainState as JTrainState
from audioanalysisdetector_tpu.train.steps import make_eval_step as j_make_eval_step
from audioanalysisdetector_tpu.train.steps import make_train_step as j_make_train_step
from audioanalysisdetector_tpu_torch.convert import (
    flax_to_torch_bilstm_classifier,
    flax_to_torch_cnn_bilstm,
    random_flax_bilstm_classifier,
    random_flax_cnn_bilstm,
    torch_to_flax_bilstm_classifier,
    torch_to_flax_cnn_bilstm,
)
from audioanalysisdetector_tpu_torch.models.bilstm_classifier import BiLSTMClassifier
from audioanalysisdetector_tpu_torch.models.cnn_bilstm import CNNBiLSTMHybrid
from audioanalysisdetector_tpu_torch.models.layers import flax_init_
from audioanalysisdetector_tpu_torch.train import losses
from audioanalysisdetector_tpu_torch.train.metrics import eer_tensor
from audioanalysisdetector_tpu_torch.train.optimizers import OPTIMIZERS, make_optimizer
from audioanalysisdetector_tpu_torch.train.state import TrainState
from audioanalysisdetector_tpu_torch.train.steps import make_eval_step, make_train_step

torch.set_num_threads(2)

# fp32 losses of the same logits, other reduction orders
LOSS_TOL = 1e-6
# 20 optimizer updates, fp32, the same rule in another order of operations
OPT_TOL = 1e-6
# 10 Adam steps (lr 1e-3) of fp32 chains summed in other orders: losses and
# parameters; BatchNorm statistics of conv outputs near 30 whose flax-rule
# variance E[x^2] - E[x]^2 loses ~1e-5 of its value to cancellation
STEP_TOL = 2e-5
BN_RTOL = 5e-5
LR = 1e-3
# parameters whose gradient is zero in exact arithmetic: the conv bias (the
# BatchNorm after it removes any per-channel shift) and, with softmax
# attention, the attention bias (softmax ignores a shift). Both packages'
# gradients there are rounding noise, which Adam turns into steps of up to
# lr each, so each is held to lr times the number of steps
NULL_GRAD = {"conv/bias", "attention/bias"}
T, F, B = 9, 16, 8  # CNN-BiLSTM: frames (conv channels), mel bins, batch
CT, CF = 7, 5  # BiLSTMClassifier: steps, features


def _logits(n_classes: int) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(0)
    return (rng.standard_normal((6, n_classes)) * 3).astype(np.float32), rng.integers(0, 2, 6)


@pytest.mark.parametrize("name", sorted(losses.LOSSES))
def test_losses_match_jax(name):
    logits, labels = _logits(1 if name == "BCELoss" else 3)
    if name == "NLLLoss":
        logits = np.array(jax.nn.log_softmax(logits, axis=-1))
    tl, tlab = torch.from_numpy(logits), torch.from_numpy(labels)
    ours = losses.get_loss(name)(tl, tlab)
    ref = jlosses.get_loss(name)(jnp.asarray(logits), jnp.asarray(labels))
    assert ours.shape == ()
    np.testing.assert_allclose(float(ours), float(ref), rtol=LOSS_TOL, atol=LOSS_TOL)
    rows = losses.get_loss_per_row(name)(tl, tlab).numpy()
    np.testing.assert_allclose(rows, np.asarray(jlosses.get_loss_per_row(name)(jnp.asarray(logits), jnp.asarray(labels))),
                               rtol=LOSS_TOL, atol=LOSS_TOL)
    np.testing.assert_allclose(rows.mean(), float(ours), rtol=LOSS_TOL)


def test_unknown_loss_and_optimizer_raise():
    with pytest.raises(ValueError, match="unknown loss"):
        losses.get_loss("HingeLoss")
    with pytest.raises(ValueError, match="unknown optimizer"):
        make_optimizer("Adagrad")


def _opt_run(name: str, tx_factory, params: dict, grads: list[dict]) -> list[dict]:
    ps = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = tx_factory(list(ps.values()))
    out = []
    for g in grads:
        for k, p in ps.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
        out.append({k: p.detach().numpy().copy() for k, p in ps.items()})
    return out


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_optimizers_match_optax(name):
    """20 updates on seeded parameters; the first 5 gradients are ~1e-5,
    where eps inside or outside RMSprop's root decides the step size."""
    rng = np.random.default_rng(1)
    params = {"w": rng.standard_normal((4, 3)).astype(np.float32), "b": rng.standard_normal(3).astype(np.float32)}
    grads = [{k: (rng.standard_normal(v.shape) * (1e-5 if i < 5 else 1.0)).astype(np.float32)
              for k, v in params.items()} for i in range(20)]
    lr = 1e-3
    ours = _opt_run(name, make_optimizer(name, lr), params, grads)
    tx = j_make_optimizer(name, lr)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    st = tx.init(jp)
    for i, g in enumerate(grads):
        upd, st = tx.update({k: jnp.asarray(v) for k, v in g.items()}, st, jp)
        jp = optax.apply_updates(jp, upd)
        for k in params:
            np.testing.assert_allclose(ours[i][k], np.asarray(jp[k]), rtol=OPT_TOL, atol=OPT_TOL, err_msg=f"step {i} {k}")
    if name == "RMSprop":
        # torch's own RMSprop (eps outside the root) misses optax by far
        theirs = _opt_run(name, lambda ps: torch.optim.RMSprop(ps, lr=lr, alpha=0.99, eps=1e-8), params, grads)
        ref = _opt_run(name, make_optimizer(name, lr), params, grads[:1])
        assert np.abs(theirs[0]["w"] - ref[0]["w"]).max() > 100 * OPT_TOL


def test_flax_init_matches_jax_init_distribution():
    """Zero biases, unit norms, LSTM tensors within +-1/sqrt(H), lecun-normal
    kernels: each tensor's std within 10% of JAX ``model.init``'s (kernels
    of >= 4096 entries) and within two of its standard deviations."""
    model = flax_init_(CNNBiLSTMHybrid(63), torch.Generator().manual_seed(0))
    ours = torch_to_flax_cnn_bilstm(model.state_dict())
    ref = JCNNBiLSTMHybrid().init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 63)), train=False)
    flat = lambda t: {"/".join(k.key for k in path): np.asarray(v) for path, v in jax.tree_util.tree_leaves_with_path(t)}  # noqa: E731
    o, r = flat(ours), flat(ref)
    assert set(o) == set(r)
    for k, a in o.items():
        b = r[k]
        assert a.shape == b.shape, k
        if k.endswith("bias") or k.endswith("mean"):
            np.testing.assert_array_equal(a, b, err_msg=k)
        elif k.endswith("scale") or k.endswith("var"):
            np.testing.assert_array_equal(a, b, err_msg=k)
        elif "bilstm" in k:
            bound = 32**-0.5
            assert np.abs(a).max() <= bound and np.abs(a).max() > 0.95 * bound, k
        else:  # conv and Dense kernels
            std = a.size // a.shape[-1]
            std = std**-0.5 / 0.87962566103423978
            assert np.abs(a).max() <= 2 * std * (1 + 1e-6), k
            if a.size >= 4096:
                assert abs(a.std() / b.std() - 1) < 0.1, k
    again = torch_to_flax_cnn_bilstm(flax_init_(CNNBiLSTMHybrid(63), torch.Generator().manual_seed(0)).state_dict())
    np.testing.assert_array_equal(again["params"]["fc1"]["kernel"], o["params/fc1/kernel"])


def _cnn_pair(fixed_attention: bool, lr: float = LR, optimizer: str = "Adam"):
    variables = random_flax_cnn_bilstm(3, T, fixed_attention=fixed_attention)
    model = CNNBiLSTMHybrid(T, fixed_attention=fixed_attention, logits=True, dropout_rate=0.0, conv_dropout=0.0)
    model.load_state_dict(flax_to_torch_cnn_bilstm(variables))
    jmodel = JCNNBiLSTMHybrid(fixed_attention=fixed_attention, logits=True, dropout_rate=0.0, conv_dropout=0.0)
    jstate = JTrainState.create(apply_fn=jmodel.apply, params=variables["params"],
                                tx=j_make_optimizer(optimizer, lr), batch_stats=variables["batch_stats"])
    return TrainState.create(model=model, tx=make_optimizer(optimizer, lr)), jstate


def _bilstm_pair(lr: float = LR):
    variables = random_flax_bilstm_classifier(4, hidden=16, input_dim=CF)
    model = BiLSTMClassifier(hidden=16, input_dim=CF, dropout=0.0)
    model.load_state_dict(flax_to_torch_bilstm_classifier(variables))
    jmodel = JBiLSTMClassifier(hidden=16, dropout=0.0)
    jstate = JTrainState.create(apply_fn=jmodel.apply, params=variables["params"],
                                tx=j_make_optimizer("Adam", lr), batch_stats={})
    return TrainState.create(model=model, tx=make_optimizer("Adam", lr)), jstate


def _cnn_batches(n: int, seed: int = 5):
    rng = np.random.default_rng(seed)
    return [((rng.standard_normal((B, F, T)) * 10 - 40).astype(np.float32), rng.integers(0, 2, B)) for _ in range(n)]


def _bilstm_batches(n: int, seed: int = 6):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((B, CT, CF)).astype(np.float32), rng.integers(0, 2, B)) for _ in range(n)]


def _run_steps(state, jstate, batches, *, loss_name, binary_head, has_batch_stats):
    step = make_train_step(losses.get_loss(loss_name), has_batch_stats=has_batch_stats, binary_head=binary_head)
    jstep = jax.jit(j_make_train_step(jlosses.get_loss(loss_name), has_batch_stats=has_batch_stats,
                                      binary_head=binary_head))
    g = torch.Generator().manual_seed(0)
    ours, ref = [], []
    for x, y in batches:
        state, m = step(state, torch.from_numpy(x), torch.from_numpy(y), g)
        jstate, jm = jstep(jstate, jnp.asarray(x), jnp.asarray(y), jax.random.PRNGKey(0))
        ours.append((float(m["loss"]), float(m["accuracy"])))
        ref.append((float(jm["loss"]), float(jm["accuracy"])))
    return state, jstate, np.asarray(ours), np.asarray(ref)


def _assert_tree_close(ours: dict, ref, tol: float, path: str = "", steps: int = 0):
    """Leaves within ``tol``; after ``steps`` Adam steps a ``NULL_GRAD``
    leaf within ``LR * steps``."""
    if isinstance(ours, dict):
        assert set(ours) == set(ref), path
        for k in ours:
            _assert_tree_close(ours[k], ref[k], tol, f"{path}/{k}".lstrip("/"), steps)
    elif path in NULL_GRAD and steps:
        assert np.abs(ours - np.asarray(ref)).max() <= LR * steps, path
    else:
        np.testing.assert_allclose(ours, np.asarray(ref), rtol=tol, atol=tol, err_msg=path)


@pytest.mark.parametrize("fixed_attention", [False, True])
def test_cnn_bilstm_train_steps_match_jax(fixed_attention):
    """10 BCE steps from the same converted init: losses, accuracies,
    parameters and the BatchNorm running statistics (flax's biased rule;
    torch's unbiased one would miss them by far)."""
    state, jstate = _cnn_pair(fixed_attention)
    batches = _cnn_batches(10)
    state, jstate, ours, ref = _run_steps(state, jstate, batches, loss_name="BCELoss",
                                          binary_head=True, has_batch_stats=True)
    np.testing.assert_allclose(ours, ref, rtol=STEP_TOL, atol=STEP_TOL)
    assert state.step == int(jstate.step) == 10
    got = torch_to_flax_cnn_bilstm(state.model.state_dict())
    _assert_tree_close(got["params"], jstate.params, STEP_TOL, steps=10)
    for k in ("mean", "var"):
        np.testing.assert_allclose(got["batch_stats"]["bn"][k], np.asarray(jstate.batch_stats["bn"][k]),
                                   rtol=BN_RTOL, atol=BN_RTOL)

    # the same steps with torch's own BatchNorm update (unbiased variance)
    state_u, _ = _cnn_pair(fixed_attention)
    state_u.model.bn.__class__ = torch.nn.BatchNorm1d
    step = make_train_step(losses.get_loss("BCELoss"), binary_head=True)
    for x, y in batches:
        step(state_u, torch.from_numpy(x), torch.from_numpy(y), torch.Generator().manual_seed(0))
    miss = np.abs(state_u.model.bn.running_var.numpy() / np.asarray(jstate.batch_stats["bn"]["var"]) - 1).max()
    assert miss > 20 * BN_RTOL


def test_bilstm_classifier_train_steps_match_jax():
    state, jstate = _bilstm_pair()
    state, jstate, ours, ref = _run_steps(state, jstate, _bilstm_batches(10), loss_name="CrossEntropyLoss",
                                          binary_head=False, has_batch_stats=False)
    np.testing.assert_allclose(ours, ref, rtol=STEP_TOL, atol=STEP_TOL)
    _assert_tree_close(torch_to_flax_bilstm_classifier(state.model.state_dict())["params"], jstate.params, STEP_TOL)


def test_has_batch_stats_false_refuses_a_batchnorm_model():
    state, _ = _cnn_pair(False)
    x, y = _cnn_batches(1)[0]
    step = make_train_step(losses.get_loss("BCELoss"), has_batch_stats=False, binary_head=True)
    with pytest.raises(ValueError, match="BatchNorm"):
        step(state, torch.from_numpy(x), torch.from_numpy(y), torch.Generator())


@pytest.mark.parametrize("model", ["cnn_bilstm", "bilstm_classifier"])
def test_eval_step_matches_jax(model):
    if model == "cnn_bilstm":
        (state, jstate), (x, y) = _cnn_pair(False), _cnn_batches(1)[0]
        kw = {"binary_head": True, "has_batch_stats": True}
        name = "BCELoss"
    else:
        (state, jstate), (x, y) = _bilstm_pair(), _bilstm_batches(1)[0]
        kw = {"binary_head": False, "has_batch_stats": False}
        name = "CrossEntropyLoss"
    ours = make_eval_step(losses.get_loss(name), **kw)(state, torch.from_numpy(x), torch.from_numpy(y))
    ref = jax.jit(j_make_eval_step(jlosses.get_loss(name), **kw))(jstate, jnp.asarray(x), jnp.asarray(y))
    assert set(ours) == set(ref)
    for k in ours:
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(ref[k]), rtol=STEP_TOL, atol=STEP_TOL, err_msg=k)
    np.testing.assert_array_equal(ours["preds"].numpy(), np.asarray(ref["preds"]))


def test_seeded_dropout_is_bit_identical_whatever_the_global_seed():
    """Dropout at the models' default rates: the same generator seed gives
    the same CPU losses bit for bit after different ``torch.manual_seed``s;
    another generator seed gives other masks."""

    def losses_for(global_seed: int, seed: int) -> list[float]:
        torch.manual_seed(global_seed)
        model = flax_init_(CNNBiLSTMHybrid(T, logits=True, fixed_attention=True), torch.Generator().manual_seed(0))
        state = TrainState.create(model=model, tx=make_optimizer("Adam", 1e-3))
        step = make_train_step(losses.get_loss("BCELoss"), binary_head=True)
        g = torch.Generator().manual_seed(seed)
        out = []
        for x, y in _cnn_batches(3):
            state, m = step(state, torch.from_numpy(x), torch.from_numpy(y), g)
            out.append(float(m["loss"]))
        return out

    first = losses_for(1, 7)
    assert first == losses_for(2, 7)
    assert first != losses_for(1, 8)


def test_dropout_in_training_mode_needs_a_generator():
    model = CNNBiLSTMHybrid(T, logits=True).train()
    with pytest.raises(ValueError, match="Generator"):
        model(torch.zeros(2, F, T))
    model.eval()(torch.zeros(2, F, T))


@pytest.mark.parametrize("case", ["random", "ties", "separable"])
def test_eer_tensor_matches_eer_jnp(case):
    rng = np.random.default_rng(9)
    y = rng.integers(0, 2, 200)
    s = {"random": rng.standard_normal(200), "ties": np.round(rng.standard_normal(200), 1),
         "separable": y + 0.1 * rng.random(200)}[case].astype(np.float32)
    ours = float(eer_tensor(torch.from_numpy(y), torch.from_numpy(s)))
    assert ours == float(eer_jnp(jnp.asarray(y), jnp.asarray(s)))
