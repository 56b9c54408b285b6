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

``flax_to_torch_bilstm_classifier`` does the same for the fused system's
``models.bilstm_classifier.BiLSTMClassifier`` (``bilstm1`` / ``bilstm2``
``fwd`` / ``bwd`` -> ``weight_*_l0[_reverse]``; ``fc``).

``random_flax_cnn_bilstm`` and ``random_flax_bilstm_classifier`` make such
trees from a numpy seed, and ``random_diag_gmm`` the numpy arrays of a
diagonal GMM, so tests and the card check feed the same numbers to both
packages without JAX.
"""

from __future__ import annotations

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):  # a bfloat16 leaf of the msgpack reader
        return a.float()
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _T(a) -> torch.Tensor:
    """A 2-D leaf transposed (Dense kernels, LSTM weights)."""
    return _t(a).T.contiguous()


def _lstm(d: dict, prefix: str, sfx: str) -> dict[str, torch.Tensor]:
    """flax ``{w_ih (I, 4H), w_hh (H, 4H), b_ih, b_hh}`` -> ``torch.nn.LSTM``'s
    layer-0 tensors, ``sfx`` ``""`` forward or ``"_reverse"`` backward."""
    return {
        f"{prefix}.weight_ih_l0{sfx}": _T(d["w_ih"]),
        f"{prefix}.weight_hh_l0{sfx}": _T(d["w_hh"]),
        f"{prefix}.bias_ih_l0{sfx}": _t(d["b_ih"]),
        f"{prefix}.bias_hh_l0{sfx}": _t(d["b_hh"]),
    }


def flax_to_torch_cnn_bilstm(variables: dict) -> dict[str, torch.Tensor]:
    """flax ``{"params", "batch_stats"}`` (numpy leaves) -> torch state_dict.
    Without ``batch_stats`` (or with it empty) the BatchNorm statistics are
    left out, so the model's own stay."""
    p, stats = variables["params"], variables.get("batch_stats")
    sd = {
        "conv.weight": _t(p["conv"]["kernel"]).permute(2, 1, 0).contiguous(),
        "conv.bias": _t(p["conv"]["bias"]),
        "bn.weight": _t(p["bn"]["scale"]),
        "bn.bias": _t(p["bn"]["bias"]),
    }
    if stats:
        sd.update({
            "bn.running_mean": _t(stats["bn"]["mean"]),
            "bn.running_var": _t(stats["bn"]["var"]),
            "bn.num_batches_tracked": torch.tensor(0, dtype=torch.int64),
        })
    for direction, sfx in (("fwd", ""), ("bwd", "_reverse")):
        sd.update(_lstm(p["bilstm"][direction], "bilstm.lstm", sfx))
    for name in ("attention", "fc1", "fc2"):
        sd[f"{name}.weight"] = _T(p[name]["kernel"])
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


def flax_to_torch_bilstm_classifier(variables: dict) -> dict[str, torch.Tensor]:
    """flax ``{"params": ...}`` of ``BiLSTMClassifier`` -> torch state_dict."""
    p = variables["params"]
    sd = {}
    for layer in ("bilstm1", "bilstm2"):
        for direction, sfx in (("fwd", ""), ("bwd", "_reverse")):
            sd.update(_lstm(p[layer][direction], f"{layer}.lstm", sfx))
    sd["fc.weight"] = _T(p["fc"]["kernel"])
    sd["fc.bias"] = _t(p["fc"]["bias"])
    return sd


def random_flax_bilstm_classifier(
    seed: int, hidden: int = 128, input_dim: int = 19, num_classes: int = 2
) -> dict:
    """A flax-layout ``BiLSTMClassifier`` ``{"params": ...}`` tree of numpy
    f32, uniform in +-1/sqrt(fan_in), from a seed."""
    rng = np.random.default_rng(seed)

    def u(shape, fan_in):
        b = 1.0 / np.sqrt(fan_in)
        return rng.uniform(-b, b, shape).astype(np.float32)

    H = hidden

    def bilstm(i):
        return {d: {"w_ih": u((i, 4 * H), H), "w_hh": u((H, 4 * H), H),
                    "b_ih": u((4 * H,), H), "b_hh": u((4 * H,), H)} for d in ("fwd", "bwd")}

    return {"params": {
        "bilstm1": bilstm(input_dim),
        "bilstm2": bilstm(2 * H),
        "fc": {"kernel": u((2 * H, num_classes), 2 * H), "bias": u((num_classes,), 2 * H)},
    }}


def random_diag_gmm(seed: int, n_components: int, dim: int) -> dict[str, np.ndarray]:
    """A diagonal GMM's ``{weights, means, variances}`` as numpy f32 from a
    seed: Dirichlet weights, standard normal means, variances in [0.5, 1.5)."""
    rng = np.random.default_rng(seed)
    return {
        "weights": rng.dirichlet(np.ones(n_components)).astype(np.float32),
        "means": rng.standard_normal((n_components, dim)).astype(np.float32),
        "variances": rng.uniform(0.5, 1.5, (n_components, dim)).astype(np.float32),
    }
