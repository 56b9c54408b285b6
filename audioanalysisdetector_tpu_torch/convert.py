"""Carry CNN-BiLSTM weights from the JAX package's flax layout to the port.

``flax_to_torch_cnn_bilstm`` takes the flax ``variables`` tree
(``{"params": ..., "batch_stats": ...}``, leaves as numpy arrays) of
the JAX package's ``models.cnn_bilstm.CNNBiLSTMHybrid`` and returns
the ``state_dict`` of ``audioanalysisdetector_tpu_torch.models.cnn_bilstm
.CNNBiLSTMHybrid``:

- conv kernel ``(3, Cin, Cout)`` -> ``(Cout, Cin, 3)``;
- Dense kernel ``(in, out)`` -> ``(out, in)``, biases as they are;
- BiLSTM ``fwd``/``bwd`` ``w_ih (I, 4H)`` / ``w_hh (H, 4H)`` ->
  ``weight_ih_l0[_reverse] (4H, I)`` / ``weight_hh_l0[_reverse] (4H, H)``,
  ``b_ih``/``b_hh`` to the two biases, gate order ``[i, f, g, o]`` kept;
- BatchNorm ``scale``/``bias``/``mean``/``var`` -> ``weight``/``bias``/
  ``running_mean``/``running_var``;
- ``layer_norm`` ``scale``/``bias`` -> ``weight``/``bias``.

``random_flax_cnn_bilstm`` makes such a tree from a numpy seed, so tests and
the card check feed the same numbers to both packages without JAX.
"""

from __future__ import annotations

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def flax_to_torch_cnn_bilstm(variables: dict) -> dict[str, torch.Tensor]:
    """flax ``{"params", "batch_stats"}`` (numpy leaves) -> torch state_dict."""
    p, stats = variables["params"], variables["batch_stats"]
    sd = {
        "conv.weight": _t(np.transpose(p["conv"]["kernel"], (2, 1, 0))),
        "conv.bias": _t(p["conv"]["bias"]),
        "bn.weight": _t(p["bn"]["scale"]),
        "bn.bias": _t(p["bn"]["bias"]),
        "bn.running_mean": _t(stats["bn"]["mean"]),
        "bn.running_var": _t(stats["bn"]["var"]),
        "bn.num_batches_tracked": torch.tensor(0, dtype=torch.int64),
    }
    for direction, sfx in (("fwd", ""), ("bwd", "_reverse")):
        d = p["bilstm"][direction]
        sd[f"bilstm.lstm.weight_ih_l0{sfx}"] = _t(np.transpose(d["w_ih"]))
        sd[f"bilstm.lstm.weight_hh_l0{sfx}"] = _t(np.transpose(d["w_hh"]))
        sd[f"bilstm.lstm.bias_ih_l0{sfx}"] = _t(d["b_ih"])
        sd[f"bilstm.lstm.bias_hh_l0{sfx}"] = _t(d["b_hh"])
    for name in ("attention", "fc1", "fc2"):
        sd[f"{name}.weight"] = _t(np.transpose(p[name]["kernel"]))
        sd[f"{name}.bias"] = _t(p[name]["bias"])
    if "layer_norm" in p:
        sd["layer_norm.weight"] = _t(p["layer_norm"]["scale"])
        sd["layer_norm.bias"] = _t(p["layer_norm"]["bias"])
    return sd


def random_flax_cnn_bilstm(
    seed: int,
    in_channels: int,
    *,
    lstm_units: int = 32,
    dense_units: int = 64,
    fixed_attention: bool = False,
) -> dict:
    """A flax-layout CNN-BiLSTM ``variables`` tree of numpy f32, from a seed.

    Weights are uniform in +-1/sqrt(fan_in); the BatchNorm statistics and the
    LayerNorm parameters are random too, so no part of the model can pass a
    comparison by being the identity."""
    rng = np.random.default_rng(seed)

    def u(shape, fan_in):
        b = 1.0 / np.sqrt(fan_in)
        return rng.uniform(-b, b, shape).astype(np.float32)

    H = lstm_units

    def lstm(i):
        return {
            "w_ih": u((i, 4 * H), H),
            "w_hh": u((H, 4 * H), H),
            "b_ih": u((4 * H,), H),
            "b_hh": u((4 * H,), H),
        }

    params = {
        "conv": {"kernel": u((3, in_channels, 64), 3 * in_channels), "bias": u((64,), 3 * in_channels)},
        "bn": {
            "scale": rng.uniform(0.5, 1.5, 64).astype(np.float32),
            "bias": rng.uniform(-0.5, 0.5, 64).astype(np.float32),
        },
        "bilstm": {"fwd": lstm(64), "bwd": lstm(64)},
        "attention": {"kernel": u((2 * H, 1), 2 * H), "bias": u((1,), 2 * H)},
        "fc1": {"kernel": u((2 * H, dense_units), 2 * H), "bias": u((dense_units,), 2 * H)},
        "fc2": {"kernel": u((dense_units, 1), dense_units), "bias": u((1,), dense_units)},
    }
    if not fixed_attention:
        params["layer_norm"] = {
            "scale": rng.uniform(0.5, 1.5, 1).astype(np.float32),
            "bias": rng.uniform(0.5, 1.5, 1).astype(np.float32),
        }
    batch_stats = {
        "bn": {
            "mean": rng.uniform(-0.5, 0.5, 64).astype(np.float32),
            "var": rng.uniform(0.5, 1.5, 64).astype(np.float32),
        }
    }
    return {"params": params, "batch_stats": batch_stats}
