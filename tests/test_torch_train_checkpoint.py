"""Checkpoints both packages read and resume, on the CPU.

The port writes the JAX package's format (a flax msgpack payload ``{step,
params, batch_stats, opt_state}`` in the flax / optax layout) with its own
msgpack codec. For the same state (converted) its file is byte for byte the
JAX package's; each package restores the other's file into its own template
state; a run resumed from the other package's checkpoint matches that
package's next 3 steps; and all of it works with ``msgpack`` and ``flax``
blocked.
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from flax import serialization

from audioanalysisdetector_tpu.models.bilstm_classifier import BiLSTMClassifier as JBiLSTMClassifier
from audioanalysisdetector_tpu.models.cnn_bilstm import CNNBiLSTMHybrid as JCNNBiLSTMHybrid
from audioanalysisdetector_tpu.train import checkpoint as jckpt
from audioanalysisdetector_tpu.train import losses as jlosses
from audioanalysisdetector_tpu.train.optimizers import make_optimizer as j_make_optimizer
from audioanalysisdetector_tpu.train.state import TrainState as JTrainState
from audioanalysisdetector_tpu.train.steps import make_train_step as j_make_train_step
from audioanalysisdetector_tpu_torch.convert import (
    flax_to_torch_bilstm_classifier,
    flax_to_torch_cnn_bilstm,
    flax_to_torch_opt_state,
    random_flax_bilstm_classifier,
    random_flax_cnn_bilstm,
    torch_to_flax_bilstm_classifier,
    torch_to_flax_cnn_bilstm,
)
from audioanalysisdetector_tpu_torch.models.bilstm_classifier import BiLSTMClassifier
from audioanalysisdetector_tpu_torch.models.cnn_bilstm import CNNBiLSTMHybrid
from audioanalysisdetector_tpu_torch.train import _msgpack, checkpoint, losses
from audioanalysisdetector_tpu_torch.train.optimizers import OPTIMIZERS, make_optimizer
from audioanalysisdetector_tpu_torch.train.state import TrainState
from audioanalysisdetector_tpu_torch.train.steps import make_train_step

torch.set_num_threads(2)

# 3 steps after a resume, fp32 chains summed in other orders (Adam, lr 1e-3)
STEP_TOL = 2e-5
LR = 1e-3
# the conv bias has a zero gradient in exact arithmetic (a BatchNorm follows
# it): both packages step it by Adam-normalised rounding noise, up to lr a step
NULL_GRAD = {"conv/bias"}
T, F, B = 9, 16, 8
ROOT = Path(__file__).resolve().parents[1]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, serialization.to_state_dict(tree))


def _models(kind: str):
    """(port model, JAX model, flax variables, loss name, binary head)."""
    if kind == "cnn_bilstm":
        v = random_flax_cnn_bilstm(3, T)
        m = CNNBiLSTMHybrid(T, logits=True, dropout_rate=0.0, conv_dropout=0.0)
        m.load_state_dict(flax_to_torch_cnn_bilstm(v))
        return m, JCNNBiLSTMHybrid(logits=True, dropout_rate=0.0, conv_dropout=0.0), v, "BCELoss", True
    v = random_flax_bilstm_classifier(4, hidden=8, input_dim=5)
    m = BiLSTMClassifier(hidden=8, input_dim=5, dropout=0.0)
    m.load_state_dict(flax_to_torch_bilstm_classifier(v))
    return m, JBiLSTMClassifier(hidden=8, dropout=0.0), {**v, "batch_stats": {}}, "CrossEntropyLoss", False


def _batches(kind: str, n: int, seed: int = 5):
    rng = np.random.default_rng(seed)
    shape = (B, F, T) if kind == "cnn_bilstm" else (B, 6, 5)
    scale, shift = (10.0, -40.0) if kind == "cnn_bilstm" else (1.0, 0.0)
    return [((rng.standard_normal(shape) * scale + shift).astype(np.float32), rng.integers(0, 2, B)) for _ in range(n)]


class Pair:
    """One model in both packages, from the same weights, stepped alike."""

    def __init__(self, kind: str, optimizer: str = "Adam"):
        self.kind = kind
        model, jmodel, v, self.loss, self.binary = _models(kind)
        self.state = TrainState.create(model=model, tx=make_optimizer(optimizer, LR))
        self.jstate = JTrainState.create(apply_fn=jmodel.apply, params=v["params"],
                                         tx=j_make_optimizer(optimizer, LR), batch_stats=v["batch_stats"])
        bn = kind == "cnn_bilstm"
        self.step = make_train_step(losses.get_loss(self.loss), has_batch_stats=bn, binary_head=self.binary)
        self.jstep = jax.jit(j_make_train_step(jlosses.get_loss(self.loss), has_batch_stats=bn,
                                               binary_head=self.binary))

    def port_steps(self, batches) -> list[float]:
        g = torch.Generator().manual_seed(0)
        out = []
        for x, y in batches:
            self.state, m = self.step(self.state, torch.from_numpy(x), torch.from_numpy(y), g)
            out.append(float(m["loss"]))
        return out

    def jax_steps(self, batches) -> list[float]:
        out = []
        for x, y in batches:
            self.jstate, m = self.jstep(self.jstate, jnp.asarray(x), jnp.asarray(y), jax.random.PRNGKey(0))
            out.append(float(m["loss"]))
        return out

    def port_variables(self) -> dict:
        sd = self.state.model.state_dict()
        if self.kind == "cnn_bilstm":
            return torch_to_flax_cnn_bilstm(sd)
        return {**torch_to_flax_bilstm_classifier(sd), "batch_stats": {}}

    def port_from_jax(self) -> None:
        """Overwrite the port's state with the JAX state, converted."""
        j = self.jstate
        v = {"params": _np(j.params), "batch_stats": _np(j.batch_stats)}
        to_torch = flax_to_torch_cnn_bilstm if self.kind == "cnn_bilstm" else flax_to_torch_bilstm_classifier
        self.state.model.load_state_dict(to_torch(v))
        flax_to_torch_opt_state(_np(j.opt_state), self.state.optimizer, self.state.model)
        self.state.step = int(j.step)


def _assert_close(ours, ref, tol: float, steps: int, path: str = ""):
    if isinstance(ref, dict):
        assert set(ours) == set(ref), path
        for k in ref:
            _assert_close(ours[k], ref[k], tol, steps, f"{path}/{k}".lstrip("/"))
    elif path in NULL_GRAD:
        assert np.abs(np.asarray(ours) - np.asarray(ref)).max() <= LR * steps, path
    else:
        np.testing.assert_allclose(np.asarray(ours), np.asarray(ref), rtol=tol, atol=tol, err_msg=path)


def _assert_equal(ours, ref, path: str = ""):
    if isinstance(ref, dict):
        assert set(ours) == set(ref), path
        for k in ref:
            _assert_equal(ours[k], ref[k], f"{path}/{k}")
    else:
        np.testing.assert_array_equal(np.asarray(ours), np.asarray(ref), err_msg=path)


CASES = [("cnn_bilstm", o) for o in OPTIMIZERS] + [("bilstm_classifier", "Adam")]


@pytest.mark.parametrize("kind,optimizer", CASES)
def test_port_file_is_byte_for_byte_jax_file(tmp_path, kind, optimizer):
    """The JAX state after 2 steps, converted to the port and saved there,
    is the file the JAX package writes for it; flax reads it."""
    pair = Pair(kind, optimizer)
    pair.jax_steps(_batches(kind, 2))
    pair.port_from_jax()
    ours, ref = tmp_path / "port.msgpack", tmp_path / "jax.msgpack"
    checkpoint.save_checkpoint(str(ours), pair.state, metadata={"epoch": 1, "val_loss": np.float32(0.5)})
    jckpt.save_checkpoint(str(ref), pair.jstate, metadata={"epoch": 1, "val_loss": np.float32(0.5)})
    assert ours.read_bytes() == ref.read_bytes()
    assert Path(f"{ours}.json").read_text() == Path(f"{ref}.json").read_text()
    payload = serialization.msgpack_restore(ours.read_bytes())
    assert set(payload) == {"step", "params", "batch_stats", "opt_state"} and int(payload["step"]) == 2


@pytest.mark.parametrize("kind,optimizer", [("cnn_bilstm", "Adam"), ("cnn_bilstm", "SGD"), ("bilstm_classifier", "Adam")])
def test_each_package_restores_the_others_file(tmp_path, kind, optimizer):
    """JAX ``restore_checkpoint`` into a fresh JAX template takes the port's
    file, and the port's takes the JAX file: the same numbers exactly."""
    pair = Pair(kind, optimizer)
    pair.port_steps(_batches(kind, 2))
    path = tmp_path / "port.msgpack"
    checkpoint.save_checkpoint(str(path), pair.state)
    restored = jckpt.restore_checkpoint(str(path), Pair(kind, optimizer).jstate)
    _assert_equal(_np(restored.params), pair.port_variables()["params"])
    _assert_equal(_np(restored.batch_stats), pair.port_variables()["batch_stats"])
    assert int(restored.step) == 2

    pair.jax_steps(_batches(kind, 2, seed=6))
    jpath = tmp_path / "jax.msgpack"
    jckpt.save_checkpoint(str(jpath), pair.jstate)
    fresh = Pair(kind, optimizer)
    checkpoint.restore_checkpoint(str(jpath), fresh.state)
    _assert_equal(fresh.port_variables()["params"], _np(pair.jstate.params))
    assert fresh.state.step == 2
    # and its optimizer state, written back, is the JAX one
    fresh_path = tmp_path / "again.msgpack"
    checkpoint.save_checkpoint(str(fresh_path), fresh.state)
    assert fresh_path.read_bytes() == jpath.read_bytes()


@pytest.mark.parametrize("optimizer", ["Adam", "RMSprop"])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_resumed_run_matches_the_other_package(tmp_path, direction, optimizer):
    """Two steps in one package, its checkpoint resumed by the other, then
    3 steps in both on the same batches: losses and weights agree."""
    kind = "cnn_bilstm"
    first, nxt = _batches(kind, 2), _batches(kind, 3, seed=7)
    pair = Pair(kind, optimizer)
    path = str(tmp_path / "ckpt.msgpack")
    if direction == "jax_to_port":
        pair.jax_steps(first)
        jckpt.save_checkpoint(path, pair.jstate)
        checkpoint.restore_checkpoint(path, pair.state)
    else:
        pair.port_steps(first)
        checkpoint.save_checkpoint(path, pair.state)
        pair.jstate = jckpt.restore_checkpoint(path, pair.jstate)
    np.testing.assert_allclose(pair.port_steps(nxt), pair.jax_steps(nxt), rtol=STEP_TOL, atol=STEP_TOL)
    assert pair.state.step == int(pair.jstate.step) == 5
    ours = pair.port_variables()
    _assert_close(ours["params"], _np(pair.jstate.params), STEP_TOL, 3)
    _assert_close(ours["batch_stats"], _np(pair.jstate.batch_stats), 5e-5, 3)


def test_params_files_cross_both_ways(tmp_path):
    pair = Pair("cnn_bilstm")
    pair.port_steps(_batches("cnn_bilstm", 1))
    checkpoint.save_params(str(tmp_path / "p.msgpack"), pair.state.model)
    got = jckpt.restore_params(str(tmp_path / "p.msgpack"), pair.jstate.params)
    _assert_equal(_np(got), pair.port_variables()["params"])
    jckpt.save_params(str(tmp_path / "j.msgpack"), pair.jstate.params)
    fresh = Pair("cnn_bilstm")
    checkpoint.restore_params(str(tmp_path / "j.msgpack"), fresh.state.model)
    _assert_equal(fresh.port_variables()["params"], _np(pair.jstate.params))


def test_writer_bytes_equal_flax():
    tree = {
        "bf16": np.arange(12, dtype=np.float32).reshape(3, 4).astype(ml_dtypes.bfloat16),
        "bf16_scalar": ml_dtypes.bfloat16(1.5),
        "ints": np.array([[-(2**40), 7], [0, 2**62]], dtype=np.int64),
        "u8": np.arange(5, dtype=np.uint8), "f64": np.linspace(-1, 1, 7), "bools": np.array([True, False]),
        "scalar_f32": np.float32(-3.25), "scalar_i32": np.int32(-7), "f64_scalar": np.float64(2.5),
        "py": {"int": 5, "neg": -33, "i8": -129, "u16": 300, "u32": 70000, "i32": -70000, "big": 2**40,
               "negbig": -(2**40), "float": 0.1, "str": "héllo", "none": None, "true": True,
               "complex": complex(1.5, -2.0), "z": {"b": 1, "a": [{"y": 1, "x": 2}]}},
        "list": [np.zeros((0, 4), np.float32), 1.0], "empty": {}, "long_str": "a" * 300,
        "many": {f"k{39 - i:03d}": i for i in range(40)}, "wide": np.ones((300, 300), np.float32),
        "step": np.asarray(3, np.int32),
    }
    ref = serialization.msgpack_serialize(tree, in_place=True)  # what flax's to_bytes writes
    assert _msgpack.to_bytes(tree) == ref
    as_torch = {**tree, "bf16": torch.arange(12, dtype=torch.float32).reshape(3, 4).to(torch.bfloat16)}
    assert _msgpack.to_bytes(as_torch) == ref


def test_writer_chunks_as_flax(monkeypatch):
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(_msgpack, "MAX_CHUNK_SIZE", 64)
    tree = {"big": np.arange(100, dtype=np.float32).reshape(10, 10),
            "nested": {"w": np.arange(33, dtype=np.int64), "small": np.ones(2, np.float32)},
            "bf16": np.arange(90, dtype=np.float32).astype(ml_dtypes.bfloat16), "in_list": [np.arange(40.0)]}
    ours = _msgpack.to_bytes(tree)
    assert isinstance(tree["big"], np.ndarray)  # chunked in a copy
    assert ours == serialization.msgpack_serialize(tree, in_place=True)
    top = np.arange(100, dtype=np.float32)
    assert _msgpack.to_bytes(top) == serialization.msgpack_serialize(top, in_place=True)


def test_save_and_restore_without_msgpack_or_flax(tmp_path):
    """The port trains a step, saves, restores into a fresh state and saves
    again, with jax, flax, optax and msgpack blocked; flax then reads the
    file and the JAX package restores it."""
    path = tmp_path / "ckpt.msgpack"
    code = (
        "import sys\n"
        "for m in ('jax', 'flax', 'optax', 'msgpack'):\n"
        "    sys.modules[m] = None\n"
        "import torch\n"
        "from audioanalysisdetector_tpu_torch.convert import flax_to_torch_cnn_bilstm, random_flax_cnn_bilstm\n"
        "from audioanalysisdetector_tpu_torch.models.cnn_bilstm import CNNBiLSTMHybrid\n"
        "from audioanalysisdetector_tpu_torch.train import TrainState, make_optimizer, make_train_step, get_loss\n"
        "from audioanalysisdetector_tpu_torch.train.checkpoint import save_checkpoint, restore_checkpoint\n"
        "def state():\n"
        f"    m = CNNBiLSTMHybrid({T}, logits=True, dropout_rate=0.0, conv_dropout=0.0)\n"
        f"    m.load_state_dict(flax_to_torch_cnn_bilstm(random_flax_cnn_bilstm(3, {T})))\n"
        "    return TrainState.create(model=m, tx=make_optimizer('AdamW', 1e-3))\n"
        "s = state()\n"
        "g = torch.Generator().manual_seed(0)\n"
        f"x = torch.randn(4, {F}, {T}, generator=g) * 10 - 40\n"
        "s, _ = make_train_step(get_loss('BCELoss'), binary_head=True)(s, x, torch.tensor([0, 1, 1, 0]), g)\n"
        f"save_checkpoint({str(path)!r}, s)\n"
        "r = restore_checkpoint(" + repr(str(path)) + ", state())\n"
        "assert r.step == 1\n"
        "for (n, a), b in zip(s.model.state_dict().items(), r.model.state_dict().values()):\n"
        "    assert torch.equal(a, b) or n == 'bn.num_batches_tracked', n\n"
        f"save_checkpoint({str(tmp_path / 'again.msgpack')!r}, r)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'optax', 'msgpack', "
        "'audioanalysisdetector_tpu') and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120, cwd=ROOT)
    assert (tmp_path / "again.msgpack").read_bytes() == path.read_bytes()
    payload = serialization.msgpack_restore(path.read_bytes())
    assert set(payload["opt_state"]) == {"0", "1", "2"} and int(payload["opt_state"]["0"]["count"]) == 1
    restored = jckpt.restore_checkpoint(str(path), Pair("cnn_bilstm", "AdamW").jstate)
    assert int(restored.step) == 1
