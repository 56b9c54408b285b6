"""The port's numpy-only reader of flax ``.msgpack`` checkpoints vs flax itself.

``audioanalysisdetector_tpu_torch.train.checkpoint.load_payload`` reads what
the JAX package's ``train/checkpoint.py::save_checkpoint`` writes, with
neither ``msgpack`` nor ``flax``. Each tree here is written by flax and read
by both ``flax.serialization.msgpack_restore`` and the port's reader; the
two trees must be equal exactly (same keys, types, dtypes, shapes and
bytes). Then a JAX-saved CNN-BiLSTM checkpoint scores the same through the
port's ``init_mel_cnn_bilstm`` and its ``score`` CLI as through the JAX
scorer.
"""

import json
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization
from flax.training import train_state

import audioanalysisdetector_tpu.frontend.mel as jmel
from audioanalysisdetector_tpu.models.bilstm_classifier import BiLSTMClassifier as JBiLSTMClassifier
from audioanalysisdetector_tpu.score.e2e import init_mel_cnn_bilstm as j_init
from audioanalysisdetector_tpu.score.e2e import make_mel_cnn_bilstm_scorer as j_make_scorer
from audioanalysisdetector_tpu.train.checkpoint import save_checkpoint
from audioanalysisdetector_tpu_torch.cli.main import main as cli_main
from audioanalysisdetector_tpu_torch.convert import random_flax_cnn_bilstm
from audioanalysisdetector_tpu_torch.frontend.mel import MelConfig
from audioanalysisdetector_tpu_torch.io.audio import load_audio, write_wav
from audioanalysisdetector_tpu_torch.score.e2e import init_mel_cnn_bilstm, make_mel_cnn_bilstm_scorer
from audioanalysisdetector_tpu_torch.train import _msgpack
from audioanalysisdetector_tpu_torch.train.checkpoint import MsgpackFormatError, load_payload

torch.set_num_threads(2)

# scores, port (converted weights, fp32 chains in other orders) vs JAX
SCORE_TOL = 1e-5


def assert_same_tree(ours, ref, path="root"):
    """Exact equality of two restored trees; a bfloat16 leaf (a torch tensor
    on our side, an ml_dtypes array on flax's) compares its 16-bit patterns."""
    if isinstance(ref, dict):
        assert isinstance(ours, dict) and list(ours) == list(ref), path
        for k in ref:
            assert_same_tree(ours[k], ref[k], f"{path}/{k}")
    elif isinstance(ref, list):
        assert isinstance(ours, list) and len(ours) == len(ref), path
        for i, (a, b) in enumerate(zip(ours, ref)):
            assert_same_tree(a, b, f"{path}[{i}]")
    elif isinstance(ref, (np.ndarray, np.generic)) and ref.dtype.name == "bfloat16":
        assert isinstance(ours, torch.Tensor) and ours.dtype == torch.bfloat16, path
        assert tuple(ours.shape) == np.shape(ref), path
        np.testing.assert_array_equal(ours.view(torch.int16).numpy(), np.asarray(ref).view(np.int16))
    elif isinstance(ref, np.ndarray):
        assert isinstance(ours, np.ndarray), path
        assert ours.dtype == ref.dtype and ours.shape == ref.shape, path
        assert ours.tobytes() == ref.tobytes(), path
    else:
        assert type(ours) is type(ref), (path, type(ours), type(ref))
        assert ours == ref, path


def _both(data: bytes):
    return _msgpack.msgpack_restore(data), serialization.msgpack_restore(data)


def test_reader_equals_flax_on_a_save_checkpoint_payload(tmp_path):
    """A ``fit()``-style payload: params, an empty batch_stats, Adam's state
    (counts, moments, empty tuples) and the step."""
    model = JBiLSTMClassifier(hidden=8)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 5, 19)))["params"]
    state = train_state.TrainState.create(apply_fn=model.apply, params=params, tx=optax.adam(1e-3))
    state = state.replace(step=state.step + 3)
    path = tmp_path / "best_model.msgpack"
    save_checkpoint(str(path), state)
    ours, ref = _both(path.read_bytes())
    assert_same_tree(ours, ref)
    assert_same_tree(load_payload(str(path)), ref)
    assert set(ours) == {"step", "params", "batch_stats", "opt_state"} and ours["batch_stats"] == {}


def test_reader_equals_flax_on_every_leaf_kind():
    tree = {
        "bf16": np.arange(12, dtype=np.float32).reshape(3, 4).astype(jnp.bfloat16),
        "bf16_scalar": jnp.bfloat16(1.5),
        "ints": np.array([[-(2**40), 7], [0, 2**62]], dtype=np.int64),
        "u8": np.arange(5, dtype=np.uint8),
        "f64": np.linspace(-1, 1, 7),
        "bools": np.array([True, False]),
        "scalar_f32": np.float32(-3.25),
        "scalar_i32": np.int32(-7),
        "py": {"int": 5, "neg": -33, "big": 2**40, "negbig": -(2**40), "float": 0.1,
               "str": "héllo", "none": None, "true": True, "complex": complex(1.5, -2.0)},
        "tuple": (np.ones(3, np.float32), 2, "x"),
        "list": [np.zeros((0, 4), np.float32), 1.0],
        "empty": {},
        "long_str": "a" * 300,
        "many": {f"k{i:03d}": i for i in range(40)},
    }
    ours, ref = _both(serialization.to_bytes(tree))
    assert_same_tree(ours, ref)


def test_reader_joins_chunked_arrays(monkeypatch):
    """flax splits arrays over MAX_CHUNK_SIZE bytes into chunk maps."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    tree = {"big": np.arange(100, dtype=np.float32).reshape(10, 10),
            "nested": {"w": np.arange(33, dtype=np.int64), "small": np.ones(2, np.float32)},
            "bf16": np.arange(90, dtype=np.float32).astype(jnp.bfloat16)}
    data = serialization.msgpack_serialize(tree)
    raw = _msgpack.loads(data)
    assert raw["big"]["__msgpack_chunked_array__"] is True and len(raw["big"]["chunks"]) > 1
    ours, ref = _both(data)
    assert_same_tree(ours, ref)
    np.testing.assert_array_equal(ours["big"], tree["big"])


def test_reader_refuses_what_is_not_msgpack():
    with pytest.raises(MsgpackFormatError, match="type byte"):
        _msgpack.loads(b"\xc1")
    with pytest.raises(MsgpackFormatError, match="truncated"):
        _msgpack.loads(serialization.msgpack_serialize({"a": np.ones(4, np.float32)})[:-3])
    with pytest.raises(MsgpackFormatError, match="trailing"):
        _msgpack.loads(b"\x01\x02")


def _cnn_payload(tmp_path, T: int, *, batch_stats: bool = True) -> tuple[str, dict]:
    variables = random_flax_cnn_bilstm(0, T)
    state = types.SimpleNamespace(
        step=np.int32(11), params=variables["params"],
        batch_stats=variables["batch_stats"] if batch_stats else {}, opt_state={},
    )
    path = tmp_path / "best_model.msgpack"
    save_checkpoint(str(path), state)
    return str(path), variables


def test_loads_a_payload_without_msgpack_or_flax(tmp_path):
    path, variables = _cnn_payload(tmp_path, 63)
    code = (
        "import sys\n"
        "for m in ('jax', 'flax', 'msgpack'):\n"
        "    sys.modules[m] = None\n"
        "from audioanalysisdetector_tpu_torch.train.checkpoint import load_payload\n"
        f"p = load_payload({path!r})\n"
        "print(float(p['params']['fc1']['kernel'].sum()), int(p['step']))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], check=True, capture_output=True, text=True,
                         timeout=120, cwd=Path(__file__).resolve().parents[1]).stdout.split()
    assert float(out[0]) == float(variables["params"]["fc1"]["kernel"].sum()) and out[1] == "11"


@pytest.mark.parametrize("batch_stats", [True, False])
def test_msgpack_checkpoint_scores_match_jax(tmp_path, batch_stats):
    """``init_mel_cnn_bilstm(checkpoint=<.msgpack>)``; without BatchNorm
    statistics in the payload both packages keep their initial ones."""
    cfg, jcfg = MelConfig.for_speech(), jmel.MelConfig.for_speech()
    T = 1 + 32000 // cfg.hop_length
    path, _ = _cnn_payload(tmp_path, T, batch_stats=batch_stats)
    wav = (np.random.default_rng(7).standard_normal((3, 32000)) * 0.1).astype(np.float32)
    model = init_mel_cnn_bilstm(cfg, 32000, checkpoint=path, device="cpu")
    ours = make_mel_cnn_bilstm_scorer(model, cfg)(torch.from_numpy(wav)).numpy()
    jmodel, jvars = j_init(jcfg, 32000, checkpoint=path)
    ref = np.asarray(j_make_scorer(jmodel.apply, jvars, jcfg)(jnp.asarray(wav)))
    np.testing.assert_allclose(ours, ref, rtol=0, atol=SCORE_TOL)
    assert np.ptp(ours) > 1e-4  # the random LayerNorm: scores differ between rows


def test_score_cli_takes_a_msgpack_checkpoint(tmp_path, capsys):
    """``python -m audioanalysisdetector_tpu_torch score <dir> --checkpoint
    best_model.msgpack --device cpu`` against the JAX scorer on the same
    decoded rows."""
    cfg, jcfg = MelConfig.for_speech(), jmel.MelConfig.for_speech()
    path, _ = _cnn_payload(tmp_path, 1 + 32000 // cfg.hop_length)
    audio = tmp_path / "audio"
    audio.mkdir()
    rng = np.random.default_rng(8)
    for i in range(3):
        write_wav(str(audio / f"u{i}.wav"), np.clip(rng.standard_normal(32000) * 0.1, -0.99, 0.99), 16000)
    rc = cli_main(["score", str(audio), "--checkpoint", path, "--device", "cpu", "--mel-profile", "speech"])
    assert rc == 0
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines() if line.strip()]
    assert len(lines) == 3
    rows = np.stack([load_audio(line["file"], sr=16000)[0][:32000] for line in lines])
    jmodel, jvars = j_init(jcfg, 32000, checkpoint=path)
    ref = np.asarray(j_make_scorer(jmodel.apply, jvars, jcfg)(jnp.asarray(rows)))
    np.testing.assert_allclose([line["spoof_score"] for line in lines], ref, rtol=0, atol=SCORE_TOL)
