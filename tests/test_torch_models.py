"""PyTorch port's LSTM layers and CNN-BiLSTM vs the JAX package, on the CPU.

Weights are made with numpy in the flax layout and carried to the port by
``convert.py`` (or, for the bare LSTM layers, by the same transposes), so
both packages run the same numbers.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audioanalysisdetector_tpu.models.cnn_bilstm import CNNBiLSTMHybrid as JCNNBiLSTMHybrid
from audioanalysisdetector_tpu.models.lstm import BiLSTM as JBiLSTM
from audioanalysisdetector_tpu.models.lstm import LSTMLayer as JLSTMLayer
from audioanalysisdetector_tpu_torch.convert import flax_to_torch_cnn_bilstm, random_flax_cnn_bilstm
from audioanalysisdetector_tpu_torch.models.cnn_bilstm import CNNBiLSTMHybrid
from audioanalysisdetector_tpu_torch.models.lstm import BiLSTM, LSTMLayer, _reverse_padded

torch.set_num_threads(2)

# fp32 recurrences of a few steps and small GEMMs, summed in other orders
TOL = 1e-5

I, H, B, T = 6, 5, 3, 9
LENGTHS = np.array([9, 4, 1])


def _lstm_params(seed):
    rng = np.random.default_rng(seed)
    b = 1 / np.sqrt(H)
    shapes = {"w_ih": (I, 4 * H), "w_hh": (H, 4 * H), "b_ih": (4 * H,), "b_hh": (4 * H,)}
    return {k: rng.uniform(-b, b, s).astype(np.float32) for k, s in shapes.items()}


def _load(lstm: torch.nn.LSTM, p: dict, sfx: str = "") -> None:
    with torch.no_grad():
        getattr(lstm, f"weight_ih_l0{sfx}").copy_(torch.from_numpy(p["w_ih"].T))
        getattr(lstm, f"weight_hh_l0{sfx}").copy_(torch.from_numpy(p["w_hh"].T))
        getattr(lstm, f"bias_ih_l0{sfx}").copy_(torch.from_numpy(p["b_ih"]))
        getattr(lstm, f"bias_hh_l0{sfx}").copy_(torch.from_numpy(p["b_hh"]))


def _x():
    return np.random.default_rng(11).standard_normal((B, T, I)).astype(np.float32)


def test_reverse_padded_matches_jax():
    from audioanalysisdetector_tpu.models.lstm import _reverse_padded as j_reverse_padded

    x = _x()
    ours = _reverse_padded(torch.from_numpy(x), torch.from_numpy(LENGTHS))
    ref = j_reverse_padded(jnp.asarray(x), jnp.asarray(LENGTHS))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


@pytest.mark.parametrize(
    "reverse,mode",
    [(False, "fixed"), (False, "last_only"), (True, "fixed"), (True, "ragged"), (True, "last_only")],
)
def test_lstm_layer_matches_jax(reverse, mode):
    p, x = _lstm_params(1), _x()
    layer = LSTMLayer(I, H, reverse=reverse)
    _load(layer.lstm, p)
    lengths = LENGTHS if mode == "ragged" else None
    last_only = mode == "last_only"
    with torch.no_grad():
        ours = layer(
            torch.from_numpy(x),
            None if lengths is None else torch.from_numpy(lengths),
            last_only=last_only,
        ).numpy()
    ref = JLSTMLayer(H, reverse=reverse).apply(
        {"params": p}, jnp.asarray(x), None if lengths is None else jnp.asarray(lengths),
        last_only=last_only,
    )
    np.testing.assert_allclose(ours, np.asarray(ref), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("mode", ["fixed", "ragged", "last_only"])
def test_bilstm_matches_jax(mode):
    pf, pb, x = _lstm_params(2), _lstm_params(3), _x()
    bi = BiLSTM(I, H)
    _load(bi.lstm, pf)
    _load(bi.lstm, pb, "_reverse")
    lengths = LENGTHS if mode == "ragged" else None
    last_only = mode == "last_only"
    with torch.no_grad():
        ours = bi(
            torch.from_numpy(x),
            None if lengths is None else torch.from_numpy(lengths),
            last_only=last_only,
        ).numpy()
    ref = JBiLSTM(H).apply(
        {"params": {"fwd": pf, "bwd": pb}},
        jnp.asarray(x), None if lengths is None else jnp.asarray(lengths),
        last_only=last_only,
    )
    assert ours.shape == np.asarray(ref).shape
    np.testing.assert_allclose(ours, np.asarray(ref), rtol=TOL, atol=TOL)


def test_last_only_refuses_ragged_input():
    lengths = torch.from_numpy(LENGTHS)
    with pytest.raises(ValueError, match="last_only"):
        BiLSTM(I, H)(torch.zeros(B, T, I), lengths, last_only=True)
    with pytest.raises(ValueError, match="last_only"):
        LSTMLayer(I, H, reverse=True)(torch.zeros(B, T, I), lengths, last_only=True)


@pytest.mark.parametrize(
    "frames,fixed_attention,logits",
    [(63, False, False), (126, False, False), (63, True, False), (126, True, True)],
)
def test_cnn_bilstm_matches_jax(frames, fixed_attention, logits):
    variables = random_flax_cnn_bilstm(5, frames, fixed_attention=fixed_attention)
    model = CNNBiLSTMHybrid(frames, fixed_attention=fixed_attention, logits=logits)
    model.load_state_dict(flax_to_torch_cnn_bilstm(variables))
    model.eval()
    # log-mel-like inputs: (B, n_mels=64, T) in dB
    x = (np.random.default_rng(6).standard_normal((4, 64, frames)) * 10 - 40).astype(np.float32)
    with torch.no_grad():
        ours = model(torch.from_numpy(x)).numpy()
    ref = JCNNBiLSTMHybrid(fixed_attention=fixed_attention, logits=logits).apply(
        variables, jnp.asarray(x), train=False
    )
    assert ours.shape == (4, 1)
    np.testing.assert_allclose(ours, np.asarray(ref), rtol=TOL, atol=TOL)
    if not logits:
        assert ((ours > 0) & (ours < 1)).all()
