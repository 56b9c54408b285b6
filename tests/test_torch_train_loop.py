"""The port's ``fit``, ``evaluate``, ``bilstm_pipeline`` and ``fit_bucketed`` vs the JAX package's, on the CPU.

Both packages start from the same weights (converted from a flax tree made
with numpy, or from the JAX ``model.init`` the JAX loop itself draws), with
every dropout rate at 0, and see the same seeded batches: every
``EpochLog`` field but ``seconds``, the best epoch, the final metrics and
the run directory's files must agree.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import audioanalysisdetector_tpu.models.bilstm_classifier as jbc
from audioanalysisdetector_tpu.models.bilstm_classifier import BiLSTMClassifier as JBiLSTMClassifier
from audioanalysisdetector_tpu.models.cnn_bilstm import CNNBiLSTMHybrid as JCNNBiLSTMHybrid
from audioanalysisdetector_tpu.train import loop as jloop
from audioanalysisdetector_tpu.train.optimizers import make_optimizer as j_make_optimizer
from audioanalysisdetector_tpu.train.state import TrainState as JTrainState
from audioanalysisdetector_tpu_torch.convert import (
    flax_to_torch_bilstm_classifier,
    flax_to_torch_cnn_bilstm,
    random_flax_cnn_bilstm,
)
from audioanalysisdetector_tpu_torch.models.bilstm_classifier import BiLSTMClassifier
from audioanalysisdetector_tpu_torch.models.cnn_bilstm import CNNBiLSTMHybrid
from audioanalysisdetector_tpu_torch.train import loop
from audioanalysisdetector_tpu_torch.train.optimizers import make_optimizer
from audioanalysisdetector_tpu_torch.train.state import TrainState

torch.set_num_threads(2)

# epoch means of fp32 losses after up to 8 Adam steps (lr 1e-3) from the
# same weights, and metrics of the same predictions
FIT_TOL = 2e-5
T, F = 9, 16  # CNN-BiLSTM frames (conv channels) and mel bins
N_TRAIN, N_VAL, BATCH = 30, 11, 8  # 30 rows: a padded tail batch
LOG_FIELDS = ("epoch", "train_loss", "train_acc", "val_loss", "val_acc")


def _cnn_data(seed: int = 1):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((N_TRAIN + N_VAL, F, T)) * 10 - 40).astype(np.float32)
    y = rng.integers(0, 2, N_TRAIN + N_VAL)
    y[N_TRAIN:N_TRAIN + 2] = (0, 1)  # both classes in val, for the EER
    return (x[:N_TRAIN], y[:N_TRAIN]), (x[N_TRAIN:], y[N_TRAIN:])


def _cnn_states():
    variables = random_flax_cnn_bilstm(3, T)
    model = CNNBiLSTMHybrid(T, logits=True, dropout_rate=0.0, conv_dropout=0.0)
    model.load_state_dict(flax_to_torch_cnn_bilstm(variables))
    jmodel = JCNNBiLSTMHybrid(logits=True, dropout_rate=0.0, conv_dropout=0.0)
    jstate = JTrainState.create(apply_fn=jmodel.apply, params=variables["params"],
                                tx=j_make_optimizer("Adam", 1e-3), batch_stats=variables["batch_stats"])
    return TrainState.create(model=model, tx=make_optimizer("Adam", 1e-3)), jstate


def _assert_logs_match(ours, ref):
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        for k in LOG_FIELDS:
            np.testing.assert_allclose(getattr(a, k), getattr(b, k), rtol=FIT_TOL, atol=FIT_TOL, err_msg=k)


def _assert_same_run_dirs(ours: str, ref: str):
    assert sorted(os.listdir(ours)) == sorted(os.listdir(ref))
    with open(os.path.join(ours, "training_log.csv")) as f, open(os.path.join(ref, "training_log.csv")) as g:
        a, b = f.read().splitlines(), g.read().splitlines()
    assert a[0] == b[0] and len(a) == len(b)


@pytest.fixture(scope="module")
def fitted(tmp_path_factory):
    """Both packages' ``fit`` for 2 epochs from the same weights."""
    d = tmp_path_factory.mktemp("fit")
    train, val = _cnn_data()
    state, jstate = _cnn_states()
    kw = dict(loss_name="BCELoss", num_epochs=2, batch_size=BATCH, binary_head=True, seed=4)
    ours = loop.fit(state, train, val, run_dir=str(d / "port"), **kw)
    ref = jloop.fit(jstate, train, val, run_dir=str(d / "jax"), **kw)
    return ours, ref, train, val, d


def test_fit_matches_jax(fitted):
    ours, ref, *_, d = fitted
    _assert_logs_match(ours.logs, ref.logs)
    assert ours.best_epoch == ref.best_epoch
    assert ours.state.step == int(ref.state.step) == 2 * -(-N_TRAIN // BATCH)
    _assert_same_run_dirs(str(d / "port"), str(d / "jax"))
    assert {"best_model.msgpack", "worst_model.msgpack", "final_model.msgpack", "logs.json",
            "training_log.txt", "loss_curve.png"} <= set(os.listdir(d / "port"))


def test_best_state_is_a_copy(fitted):
    ours, *_ = fitted
    assert ours.best_state.model is not ours.state.model
    assert ours.best_state.optimizer is not ours.state.optimizer
    best = dict(ours.best_state.model.named_parameters())
    for name, p in ours.state.model.named_parameters():
        assert best[name] is not p
        if ours.best_epoch == len(ours.logs) - 1:
            torch.testing.assert_close(best[name], p, rtol=0, atol=0)


def test_evaluate_matches_jax(fitted):
    ours, ref, _, val, _ = fitted
    got = loop.evaluate(ours.best_state, val, loss_name="BCELoss", binary_head=True)
    want = jloop.evaluate(ref.best_state, val, loss_name="BCELoss", binary_head=True)
    assert set(got) == set(want) == {"accuracy", "f1", "eer", "loss"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=FIT_TOL, atol=FIT_TOL, err_msg=k)


def test_fit_takes_tensors_as_it_takes_arrays():
    """Features already in tensors (the card's case) give the same run."""
    train, val = _cnn_data()
    kw = dict(loss_name="BCELoss", num_epochs=1, batch_size=BATCH, binary_head=True, plots=False)
    a = loop.fit(_cnn_states()[0], train, val, **kw)
    as_t = lambda d: tuple(torch.from_numpy(np.asarray(v)) for v in d)  # noqa: E731
    b = loop.fit(_cnn_states()[0], as_t(train), as_t(val), **kw)
    assert [(r.train_loss, r.val_loss, r.train_acc) for r in a.logs] == [
        (r.train_loss, r.val_loss, r.train_acc) for r in b.logs]


def test_fit_refuses_data_parallel():
    """``data_parallel=True`` in a process that joined no process group is
    one device: the JAX package's ValueError (its 2-rank run is
    tests/test_torch_parallel.py's)."""
    train, val = _cnn_data()
    with pytest.raises(ValueError, match="data_parallel=True but only one local device"):
        loop.fit(_cnn_states()[0], train, val, loss_name="BCELoss", binary_head=True, data_parallel=True)
    assert not loop.would_use_dp(BATCH)


def test_batch_iter_matches_jax():
    x = np.arange(22 * 3).reshape(22, 3)
    y = np.arange(22)
    for kw in ({"shuffle": True, "seed": 5}, {"shuffle": False, "pad_tail": False}):
        ours = list(loop.batch_iter(x, y, 8, **kw))
        ref = list(jloop.batch_iter(x, y, 8, **kw))
        assert len(ours) == len(ref)
        for (a, b, n), (c, d, m) in zip(ours, ref):
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(b, d)
            assert n == m


class _JNoDropout(JBiLSTMClassifier):
    dropout: float = 0.0


def _load_into(variables):
    """A stand-in for ``flax_init_`` that loads converted flax weights."""
    def init(model, generator):
        model.load_state_dict(flax_to_torch_bilstm_classifier(variables))
        return model
    return init


def _sequences(n: int, seed: int, lengths=(4, 6, 9)):
    rng = np.random.default_rng(seed)
    seqs = [rng.standard_normal((int(rng.choice(lengths)), 5)).astype(np.float32) for _ in range(n)]
    y = rng.integers(0, 2, n)
    y[:2] = (0, 1)
    return seqs, y


def test_bilstm_pipeline_matches_jax(tmp_path, monkeypatch):
    """The JAX pipeline's own ``model.init`` (dropout patched to 0),
    converted, starts the port's."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((27, 6, 5)).astype(np.float32)
    y = rng.integers(0, 2, 27)
    y[20:22] = (0, 1)
    train, test = (x[:20], y[:20]), (x[20:], y[20:])
    variables = _JNoDropout(hidden=8).init(jax.random.PRNGKey(2), jnp.asarray(x[:1]), train=False)
    monkeypatch.setattr(jbc, "BiLSTMClassifier", _JNoDropout)
    monkeypatch.setattr(loop, "BiLSTMClassifier", functools.partial(BiLSTMClassifier, dropout=0.0))
    monkeypatch.setattr(loop, "flax_init_", _load_into(variables))
    kw = dict(num_epochs=2, batch_size=8, hidden=8, seed=2, lr=1e-3)
    ours, got = loop.bilstm_pipeline(train, test, model_dir=str(tmp_path / "port"), device="cpu", **kw)
    ref, want = jloop.bilstm_pipeline(train, test, model_dir=str(tmp_path / "jax"), **kw)
    _assert_logs_match(ours.logs, ref.logs)
    assert ours.best_epoch == ref.best_epoch
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=FIT_TOL, atol=FIT_TOL, err_msg=k)
    run = "Adam_CrossEntropyLoss_lr0_001"
    _assert_same_run_dirs(str(tmp_path / "port" / run), str(tmp_path / "jax" / run))
    assert "metrics.json" in os.listdir(tmp_path / "port" / run)


def test_fit_bucketed_matches_jax(tmp_path, monkeypatch):
    """Ragged sequences over the same length ladder: logs, best epoch, and
    the number of distinct batch shapes the step saw."""
    seqs, y = _sequences(30, 8)
    vseqs, vy = _sequences(9, 9)
    variables = JBiLSTMClassifier(hidden=8, dropout=0.0).init(jax.random.PRNGKey(3), jnp.zeros((1, 9, 5)), train=False)
    monkeypatch.setattr(loop, "flax_init_", _load_into(variables))
    kw = dict(num_epochs=2, batch_size=8, n_buckets=3, seed=3, lr=1e-3)
    ours = loop.fit_bucketed(BiLSTMClassifier(hidden=8, input_dim=5, dropout=0.0), seqs, y, vseqs, vy,
                             run_dir=str(tmp_path / "port"), **kw)
    ref = jloop.fit_bucketed(JBiLSTMClassifier(hidden=8, dropout=0.0), seqs, y, vseqs, vy,
                             run_dir=str(tmp_path / "jax"), **kw)
    _assert_logs_match(ours.logs, ref.logs)
    assert ours.best_epoch == ref.best_epoch
    assert ours.n_compiled_shapes == ref.n_compiled_shapes == 3
    _assert_same_run_dirs(str(tmp_path / "port"), str(tmp_path / "jax"))
