"""Carry weights and optimizer state between the JAX package's flax layout and the port.

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
``torch_to_flax_cnn_bilstm`` and ``torch_to_flax_bilstm_classifier`` are
their exact inverses (numpy float32 leaves, keys in the order flax's
``model.init`` makes them). Both directions read one table per model
(``_layout``).

``torch_to_flax_opt_state`` writes a torch optimizer's state in the layout
optax's ``opt_state`` serialises to (``train.optimizers``' four
optimizers), and ``flax_to_torch_opt_state`` loads such a tree into a
torch optimizer:

- Adam ``{"0": {"count", "mu", "nu"}, "1": {}}``, AdamW the same plus
  ``"2": {}``; ``mu``/``nu`` are torch's ``exp_avg``/``exp_avg_sq`` and
  ``count`` its per-parameter ``step``;
- SGD ``{"0": {"trace"}, "1": {}}``, torch's ``momentum_buffer``;
- RMSprop ``{"0": {"nu"}, "1": {}, "2": {}}``.

The moments are parameter-shaped and take the parameters' own transposes.

``random_flax_cnn_bilstm`` and ``random_flax_bilstm_classifier`` make such
trees from a numpy seed, and ``random_diag_gmm`` the numpy arrays of a
diagonal GMM, so tests and the card check feed the same numbers to both
packages without JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from audioanalysisdetector_tpu_torch.models.bilstm_classifier import BiLSTMClassifier
from audioanalysisdetector_tpu_torch.models.cnn_bilstm import CNNBiLSTMHybrid

# how a flax leaf becomes the torch tensor: "" as it is, "T" transposed
# (Dense kernels, LSTM weights), "conv" (3, Cin, Cout) -> (Cout, Cin, 3)
_LSTM_PARTS = (("weight_ih_l0", "w_ih", "T"), ("weight_hh_l0", "w_hh", "T"),
               ("bias_ih_l0", "b_ih", ""), ("bias_hh_l0", "b_hh", ""))


def _lstm_layout(torch_prefix: str, flax_path: tuple) -> list[tuple[str, tuple, str]]:
    return [
        (f"{torch_prefix}.{t}{sfx}", (*flax_path, direction, f), how)
        for direction, sfx in (("fwd", ""), ("bwd", "_reverse"))
        for t, f, how in _LSTM_PARTS
    ]


def _dense(name: str) -> list[tuple[str, tuple, str]]:
    return [(f"{name}.weight", (name, "kernel"), "T"), (f"{name}.bias", (name, "bias"), "")]


def _cnn_bilstm_layout(layer_norm: bool) -> list[tuple[str, tuple, str]]:
    """(torch name, flax params path, transform) for every parameter."""
    norm = [("layer_norm.weight", ("layer_norm", "scale"), ""),
            ("layer_norm.bias", ("layer_norm", "bias"), "")] if layer_norm else []
    return [
        ("conv.weight", ("conv", "kernel"), "conv"), ("conv.bias", ("conv", "bias"), ""),
        ("bn.weight", ("bn", "scale"), ""), ("bn.bias", ("bn", "bias"), ""),
        *_lstm_layout("bilstm.lstm", ("bilstm",)),
        *_dense("attention"), *norm, *_dense("fc1"), *_dense("fc2"),
    ]


def _bilstm_classifier_layout() -> list[tuple[str, tuple, str]]:
    return [*_lstm_layout("bilstm1.lstm", ("bilstm1",)),
            *_lstm_layout("bilstm2.lstm", ("bilstm2",)), *_dense("fc")]


_BN_STATS = (("bn.running_mean", ("bn", "mean")), ("bn.running_var", ("bn", "var")))


def _layout(model: torch.nn.Module) -> list[tuple[str, tuple, str]]:
    if isinstance(model, CNNBiLSTMHybrid):
        return _cnn_bilstm_layout(not model.fixed_attention)
    if isinstance(model, BiLSTMClassifier):
        return _bilstm_classifier_layout()
    raise TypeError(f"no flax layout for {type(model).__name__}")


def _to_torch(a, how: str) -> torch.Tensor:
    t = a.float() if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a, dtype=np.float32))
    if how == "T":
        return t.T.contiguous()
    if how == "conv":
        return t.permute(2, 1, 0).contiguous()
    return t


def _to_flax(t: torch.Tensor, how: str) -> np.ndarray:
    a = t.detach().to("cpu", torch.float32).numpy()
    if how == "T":
        a = a.T
    elif how == "conv":
        a = a.transpose(2, 1, 0)
    return np.ascontiguousarray(a)


def _get(tree: dict, path: tuple):
    for k in path:
        tree = tree[k]
    return tree


def _put(tree: dict, path: tuple, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _flax_to_torch(p: dict, layout) -> dict[str, torch.Tensor]:
    return {name: _to_torch(_get(p, path), how) for name, path, how in layout}


def _torch_to_flax(sd: dict, layout) -> dict:
    params: dict = {}
    for name, path, how in layout:
        _put(params, path, _to_flax(sd[name], how))
    return params


def flax_to_torch_cnn_bilstm(variables: dict) -> dict[str, torch.Tensor]:
    """flax ``{"params", "batch_stats"}`` (numpy leaves) -> torch state_dict.
    Without ``batch_stats`` (or with it empty) the BatchNorm statistics are
    left out, so the model's own stay."""
    p, stats = variables["params"], variables.get("batch_stats")
    sd = _flax_to_torch(p, _cnn_bilstm_layout("layer_norm" in p))
    if stats:
        sd.update({name: _to_torch(_get(stats, path), "") for name, path in _BN_STATS})
        sd["bn.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)
    return sd


def torch_to_flax_cnn_bilstm(state_dict: dict[str, torch.Tensor]) -> dict:
    """The inverse of ``flax_to_torch_cnn_bilstm``: ``{"params",
    "batch_stats"}`` with numpy float32 leaves."""
    params = _torch_to_flax(state_dict, _cnn_bilstm_layout("layer_norm.weight" in state_dict))
    stats: dict = {}
    for name, path in _BN_STATS:
        _put(stats, path, _to_flax(state_dict[name], ""))
    return {"params": params, "batch_stats": stats}


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
    return _flax_to_torch(variables["params"], _bilstm_classifier_layout())


def torch_to_flax_bilstm_classifier(state_dict: dict[str, torch.Tensor]) -> dict:
    """The inverse of ``flax_to_torch_bilstm_classifier``: ``{"params"}``."""
    return {"params": _torch_to_flax(state_dict, _bilstm_classifier_layout())}


def _opt_kind(optimizer: torch.optim.Optimizer) -> str:
    from audioanalysisdetector_tpu_torch.train.optimizers import RMSprop  # train imports this module

    for cls, kind in ((torch.optim.AdamW, "AdamW"), (torch.optim.Adam, "Adam"),
                      (torch.optim.SGD, "SGD"), (RMSprop, "RMSprop")):
        if isinstance(optimizer, cls):
            return kind
    raise TypeError(f"no optax layout for {type(optimizer).__name__}")


# optax state name -> the torch optimizer's per-parameter state key
_MOMENTS = {"Adam": {"mu": "exp_avg", "nu": "exp_avg_sq"}, "AdamW": {"mu": "exp_avg", "nu": "exp_avg_sq"},
            "SGD": {"trace": "momentum_buffer"}, "RMSprop": {"nu": "nu"}}
# the empty states optax chains after the first transform
_EMPTY_TAIL = {"Adam": 1, "AdamW": 2, "SGD": 1, "RMSprop": 2}


def _named_params(optimizer, model) -> list[tuple[int, torch.Tensor, str, tuple, str]]:
    """(index in the optimizer's state_dict, parameter, torch name, flax
    path, transform) for every parameter the optimizer holds."""
    by_id = {id(p): name for name, p in model.named_parameters()}
    where = {name: (path, how) for name, path, how in _layout(model)}
    params = [p for group in optimizer.param_groups for p in group["params"]]
    return [(i, p, by_id[id(p)], *where[by_id[id(p)]]) for i, p in enumerate(params)]


def torch_to_flax_opt_state(optimizer: torch.optim.Optimizer, model: torch.nn.Module) -> dict:
    """The optimizer's state as optax's ``opt_state`` of the same run
    serialises it (numpy leaves; zeros and count 0 before the first step)."""
    kind = _opt_kind(optimizer)
    first: dict = {}
    count = 0
    for _, p, _, path, how in _named_params(optimizer, model):
        state = optimizer.state.get(p, {})
        if "step" in state:
            count = int(state["step"])
        for optax_name, key in _MOMENTS[kind].items():
            t = state.get(key)
            _put(first.setdefault(optax_name, {}), path,
                 _to_flax(t if t is not None else torch.zeros_like(p), how))
    if kind in ("Adam", "AdamW"):
        first = {"count": np.asarray(count, np.int32), **first}
    return {"0": first, **{str(i + 1): {} for i in range(_EMPTY_TAIL[kind])}}


def flax_to_torch_opt_state(
    opt_state: dict, optimizer: torch.optim.Optimizer, model: torch.nn.Module
) -> torch.optim.Optimizer:
    """Load an optax ``opt_state`` tree (the layout above) into
    ``optimizer``, whose parameters are ``model``'s; returns it."""
    kind = _opt_kind(optimizer)
    first = opt_state["0"]
    sd = optimizer.state_dict()
    sd["state"] = {}
    for i, p, _, path, how in _named_params(optimizer, model):
        state = {key: _to_torch(_get(first[optax_name], path), how).to(p.device)
                 for optax_name, key in _MOMENTS[kind].items()}
        if kind in ("Adam", "AdamW"):
            state["step"] = torch.tensor(float(np.asarray(first["count"])), dtype=torch.float32)
        sd["state"][i] = state
    optimizer.load_state_dict(sd)
    return optimizer


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
