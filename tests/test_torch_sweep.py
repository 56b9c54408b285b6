"""The port's training sweep and notebook drivers vs the JAX package's, on the CPU.

A sweep cell (``train_feature_model``) writes the JAX package's artifacts
(the scaler ``.npz``, logs and metrics JSON, the run directory of ``fit``)
under the same names, its scaler equal to the JAX ``FrameScaler``'s; its
``best_model.msgpack`` restores in the JAX package into a template built
with the JAX sweep's optimizer (for SGD, Adam's chained L2 and AdamW, whose
optax states have three different trees) and scores as the port's model
does. The same for ``train_mfca`` (MobileNet-MFCA, chained Adam) and
``train_3features`` (the 3-input net, plain Adam), and the grid of
``train_all_features``.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from audioanalysisdetector_tpu.data.scaler import FrameScaler as JFrameScaler
from audioanalysisdetector_tpu.models.mobilenet_mfca import MobileNetMFCA as JMobileNetMFCA
from audioanalysisdetector_tpu.models.resnet import AntiSpoofingResNet as JAntiSpoofingResNet
from audioanalysisdetector_tpu.models.resnet import MoreFeaturesClassifier as JMoreFeaturesClassifier
from audioanalysisdetector_tpu.train import checkpoint as jckpt
from audioanalysisdetector_tpu.train import sweep as jsweep
from audioanalysisdetector_tpu.train.state import TrainState as JTrainState
from audioanalysisdetector_tpu_torch.models.mobilenet_mfca import MobileNetMFCA
from audioanalysisdetector_tpu_torch.models.resnet import AntiSpoofingResNet, MoreFeaturesClassifier
from audioanalysisdetector_tpu_torch.train import checkpoint
from audioanalysisdetector_tpu_torch.train.state import TrainState
from audioanalysisdetector_tpu_torch.train.sweep import (
    _sweep_optimizer,
    train_3features,
    train_all_features,
    train_feature_model,
    train_mfca,
)

torch.set_num_threads(2)

# the restored checkpoint scored by both packages: the same weights, fp32
# convolutions summed in other orders (tests/test_torch_resnet.py's band)
SCORE_RTOL = 2e-5
N = 8


def _data(shape, seed: int = 0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, *shape)).astype(np.float32)
    y = np.arange(N) % 2
    x[y == 1] += 0.5
    return x, y


def _files(d) -> set[str]:
    return {os.path.relpath(os.path.join(r, f), d) for r, _, fs in os.walk(d) for f in fs}


def _restored_scores(path: str, jmodel, jtx, port_model, port_tx, xs: tuple) -> tuple[np.ndarray, np.ndarray]:
    """(JAX logits, port logits) of one checkpoint: restored by the JAX
    package into a template of ``jmodel`` / ``jtx``, and by the port into
    one of ``port_model`` / ``port_tx``."""
    v = jax.jit(lambda *x: jmodel.init(jax.random.PRNGKey(1), *x, train=False))(*(jnp.asarray(x[:1]) for x in xs))
    template = JTrainState.create(apply_fn=jmodel.apply, params=v["params"], tx=jtx, batch_stats=v["batch_stats"])
    restored = jckpt.restore_checkpoint(path, template)
    apply = jax.jit(lambda v, *x: jmodel.apply(v, *x, train=False))
    ref = np.asarray(apply({"params": restored.params, "batch_stats": restored.batch_stats}, *(jnp.asarray(x) for x in xs)))
    state = checkpoint.restore_checkpoint(path, TrainState.create(model=port_model, tx=port_tx))
    got = state.model.eval()(*(torch.from_numpy(x) for x in xs)).detach().numpy()
    return ref, got


def _close(ref: np.ndarray, got: np.ndarray) -> None:
    np.testing.assert_allclose(got, ref, rtol=SCORE_RTOL, atol=SCORE_RTOL * np.abs(ref).max())


@pytest.mark.parametrize("optimizer", ["Adam", "AdamW", "SGD"])
def test_sweep_cell_checkpoint_restores_in_jax(tmp_path, optimizer):
    x, y = _data((16, 12))
    out = train_feature_model(x, y, x, y, feature_name="cqcc", optimizer_name=optimizer, epochs=1, batch_size=4,
                              out_dir=str(tmp_path), device="cpu")
    cell = tmp_path / f"{optimizer}_CrossEntropyLoss"
    assert out["run_dir"] == str(cell / "cqcc") and set(out["best"]) >= {"accuracy", "f1", "eer", "loss"}
    scaler = np.load(cell / "cqcc_scaler.npz")
    ref_scaler = JFrameScaler.fit(x.reshape(-1, x.shape[-1]))
    np.testing.assert_array_equal(scaler["mean"], ref_scaler.mean)
    np.testing.assert_array_equal(scaler["std"], ref_scaler.std)
    tr = ((x - scaler["mean"]) / scaler["std"]).astype(np.float32)
    ref, got = _restored_scores(str(cell / "cqcc" / "best_model.msgpack"), JAntiSpoofingResNet(),
                                jsweep._sweep_optimizer(optimizer, 1e-4), AntiSpoofingResNet(),
                                _sweep_optimizer(optimizer, 1e-4), (tr,))
    _close(ref, got)
    assert json.loads((cell / "cqcc_metrics.json").read_text())["best"] == out["best"]


def test_sweep_cell_artifacts_match_jax(tmp_path):
    """The port's cell directory holds the files the JAX package's holds."""
    x, y = _data((8, 12), seed=1)
    train_feature_model(x, y, x, y, feature_name="mfcc", epochs=1, batch_size=4, out_dir=str(tmp_path / "port"),
                        device="cpu")
    jsweep.train_feature_model(x, y, x, y, feature_name="mfcc", epochs=1, batch_size=4,
                               out_dir=str(tmp_path / "jax"))
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    logs = json.loads((tmp_path / "port" / "Adam_CrossEntropyLoss" / "mfcc_logs.json").read_text())
    assert [r["epoch"] for r in logs] == [0]


def test_sweep_optimizers_are_the_reference_grid():
    p = [torch.nn.Parameter(torch.zeros(2))]
    sgd, adam, adamw = (_sweep_optimizer(n, 3e-4)(p) for n in ("SGD", "Adam", "AdamW"))
    assert type(sgd) is torch.optim.SGD and sgd.defaults["lr"] == 1e-3 and sgd.defaults["momentum"] == 0.9
    assert type(adam) is torch.optim.Adam and adam.defaults["weight_decay"] == 1e-5 and adam.defaults["lr"] == 3e-4
    assert type(adamw) is torch.optim.AdamW and adamw.defaults["weight_decay"] == 1e-5
    with pytest.raises(ValueError, match="unknown sweep optimizer"):
        _sweep_optimizer("RMSprop", 1e-4)


def test_train_mfca_checkpoint_restores_in_jax(tmp_path):
    x, y = _data((32, 32), seed=2)
    out = train_mfca(x, y, x, y, epochs=1, batch_size=4, out_dir=str(tmp_path), device="cpu")
    assert json.loads((tmp_path / "metrics.json").read_text()) == {"best": out["best"], "final": out["final"]}
    assert {"best_model.msgpack", "final_model.msgpack", "logs.json", "training_log.csv"} <= _files(tmp_path)
    tx = optax.chain(optax.add_decayed_weights(1e-5), optax.adam(1e-4))
    _close(*_restored_scores(str(tmp_path / "best_model.msgpack"), JMobileNetMFCA(), tx, MobileNetMFCA(),
                             _sweep_optimizer("Adam", 1e-4), (x,)))


def test_train_3features_checkpoint_restores_in_jax(tmp_path):
    feats = tuple(_data(s, seed=3 + i)[0] for i, s in enumerate(((16, 12), (8, 9), (10, 10))))
    y = np.arange(N) % 2
    out = train_3features(feats, y, feats, y, epochs=1, batch_size=4, out_dir=str(tmp_path), device="cpu")
    assert set(out) == {"best", "final", "run_dir"}
    _close(*_restored_scores(str(tmp_path / "final_model.msgpack"), JMoreFeaturesClassifier(), optax.adam(1e-4),
                             MoreFeaturesClassifier(), torch.optim.Adam, feats))


def test_train_all_features_grid(tmp_path):
    x, y = _data((8, 12), seed=4)
    results = train_all_features({"mfcc": (x, x), "cqcc": (x[:, :6], x[:, :6])}, y, y, optimizers=("SGD", "AdamW"),
                                 criteria=("MSELoss",), epochs=1, batch_size=8, out_dir=str(tmp_path), device="cpu")
    assert [(r["optimizer"], r["criterion"], r["feature"]) for r in results] == [
        ("SGD", "MSELoss", "mfcc"), ("SGD", "MSELoss", "cqcc"), ("AdamW", "MSELoss", "mfcc"), ("AdamW", "MSELoss", "cqcc")]
    summary = json.loads((tmp_path / "sweep_summary.json").read_text())
    assert [r["run_dir"] for r in summary] == [r["run_dir"] for r in results]
