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

The 2-D models (``models.resnet.AntiSpoofingResNet``,
``MoreFeaturesClassifier``, ``models.mobilenet_mfca.MobileNetMFCA``) name
their modules as the flax tree does, so their table is read off the state
dict (``_mirrored_layout``): a conv kernel ``(kh, kw, in / groups, out)``
(HWIO) -> ``(out, in / groups, kh, kw)`` (OIHW; a depthwise ``(3, 3, 1, C)``
-> ``(C, 1, 3, 3)``), Dense kernels transposed, BatchNorm as above. flax
creates no parameters for a submodule that is never called, so the ResNet's
``shortcut_conv`` / ``shortcut_bn`` exist in ``block0`` alone, in both
trees. ``flax_to_torch_resnet`` / ``_more_features`` / ``_mobilenet_mfca``
and their ``torch_to_flax_*`` inverses are that one rule.

``torch_to_flax_opt_state`` writes a torch optimizer's state in the layout
optax's ``opt_state`` serialises to (``train.optimizers``' four
optimizers), and ``flax_to_torch_opt_state`` loads such a tree into a
torch optimizer:

- Adam ``{"0": {"count", "mu", "nu"}, "1": {}}``, AdamW the same plus
  ``"2": {}``; ``mu``/``nu`` are torch's ``exp_avg``/``exp_avg_sq`` and
  ``count`` its per-parameter ``step``;
- SGD ``{"0": {"trace"}, "1": {}}``, torch's ``momentum_buffer``;
- RMSprop ``{"0": {"nu"}, "1": {}, "2": {}}``;
- Adam with L2 weight decay (torch ``Adam(weight_decay > 0)``, the sweep's
  ``optax.chain(add_decayed_weights(wd), adam(lr))``, the same update):
  ``{"0": {}, "1": {"0": {"count", "mu", "nu"}, "1": {}}}``.

The moments are parameter-shaped and take the parameters' own transposes.

``random_flax_cnn_bilstm``, ``random_flax_bilstm_classifier`` and
``random_flax_resnet`` / ``_more_features`` / ``_mobilenet_mfca`` make such
trees from a numpy seed, and ``random_diag_gmm`` the numpy arrays of a
diagonal GMM, so tests and the card check feed the same numbers to both
packages without JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from audioanalysisdetector_tpu_torch.models.bilstm_classifier import BiLSTMClassifier
from audioanalysisdetector_tpu_torch.models.cnn_bilstm import CNNBiLSTMHybrid
from audioanalysisdetector_tpu_torch.models.mobilenet_mfca import MobileNetMFCA
from audioanalysisdetector_tpu_torch.models.resnet import AntiSpoofingResNet, MoreFeaturesClassifier

# the 2-D models, whose module names follow the flax tree
MIRRORED = (AntiSpoofingResNet, MoreFeaturesClassifier, MobileNetMFCA)

# how a flax leaf becomes the torch tensor: "" as it is, "T" transposed
# (Dense kernels, LSTM weights), "conv" (3, Cin, Cout) -> (Cout, Cin, 3),
# "conv2d" HWIO -> OIHW
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


def _mirrored_layout(state_dict: dict) -> tuple[list[tuple[str, tuple, str]], list[tuple[str, tuple]]]:
    """(params table, batch_stats table) of a model whose module names are
    the flax tree's: a module with running statistics is a BatchNorm, a 4-D
    weight a conv kernel, a 2-D one a Dense kernel."""
    params, stats = [], []
    for name, t in state_dict.items():
        module, leaf = name.rsplit(".", 1)
        path = tuple(module.split("."))
        if leaf == "weight":
            if f"{module}.running_mean" in state_dict:
                params.append((name, (*path, "scale"), ""))
            else:
                params.append((name, (*path, "kernel"), "conv2d" if t.dim() == 4 else "T"))
        elif leaf == "bias":
            params.append((name, (*path, "bias"), ""))
        elif leaf in ("running_mean", "running_var"):
            stats.append((name, (*path, leaf[len("running_"):])))
    return params, stats


def _layout(model: torch.nn.Module) -> list[tuple[str, tuple, str]]:
    if isinstance(model, CNNBiLSTMHybrid):
        return _cnn_bilstm_layout(not model.fixed_attention)
    if isinstance(model, BiLSTMClassifier):
        return _bilstm_classifier_layout()
    if isinstance(model, MIRRORED):
        return _mirrored_layout(model.state_dict())[0]
    raise TypeError(f"no flax layout for {type(model).__name__}")


def _to_torch(a, how: str) -> torch.Tensor:
    t = a.float() if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a, dtype=np.float32))
    if how == "T":
        return t.T.contiguous()
    if how == "conv":
        return t.permute(2, 1, 0).contiguous()
    if how == "conv2d":
        return t.permute(3, 2, 0, 1).contiguous()
    return t


def _to_flax(t: torch.Tensor, how: str) -> np.ndarray:
    a = t.detach().to("cpu", torch.float32).numpy()
    if how == "T":
        a = a.T
    elif how == "conv":
        a = a.transpose(2, 1, 0)
    elif how == "conv2d":
        a = a.transpose(2, 3, 1, 0)
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


def _flax_to_torch_mirrored(variables: dict) -> dict[str, torch.Tensor]:
    """flax ``{"params", "batch_stats"}`` of a 2-D model -> torch state_dict
    (the table read off the flax tree; without ``batch_stats`` the model's
    own statistics stay)."""
    sd: dict[str, torch.Tensor] = {}

    def walk(tree: dict, prefix: tuple) -> None:
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, (*prefix, k))
                continue
            module = ".".join(prefix)
            if k == "kernel":
                sd[f"{module}.weight"] = _to_torch(v, "conv2d" if np.ndim(v) == 4 else "T")
            elif k == "scale":
                sd[f"{module}.weight"] = _to_torch(v, "")
            elif k == "bias":
                sd[f"{module}.bias"] = _to_torch(v, "")
            else:  # batch_stats: mean / var
                sd[f"{module}.running_{k}"] = _to_torch(v, "")
                sd.setdefault(f"{module}.num_batches_tracked", torch.tensor(0, dtype=torch.int64))

    walk(variables["params"], ())
    walk(variables.get("batch_stats") or {}, ())
    return sd


def _torch_to_flax_mirrored(state_dict: dict[str, torch.Tensor]) -> dict:
    """The inverse of ``_flax_to_torch_mirrored``: ``{"params",
    "batch_stats"}`` with numpy float32 leaves."""
    params, stats = _mirrored_layout(state_dict)
    out_stats: dict = {}
    for name, path in stats:
        _put(out_stats, path, _to_flax(state_dict[name], ""))
    return {"params": _torch_to_flax(state_dict, params), "batch_stats": out_stats}


flax_to_torch_resnet = flax_to_torch_more_features = flax_to_torch_mobilenet_mfca = _flax_to_torch_mirrored
torch_to_flax_resnet = torch_to_flax_more_features = torch_to_flax_mobilenet_mfca = _torch_to_flax_mirrored


def _random_flax_mirrored(model: torch.nn.Module, seed: int) -> dict:
    """A flax-layout ``variables`` tree of ``model``'s shapes, numpy f32 from
    a seed: conv and Dense kernels uniform in +-sqrt(6 / fan_in) (the fan-in
    scale that keeps activations near unit size through the depth), biases
    in +-0.1, BatchNorm scales in [0.5, 1.5), shifts in +-0.5, statistics
    means in +-0.5 and variances in [0.5, 1.5): no layer is the identity."""
    rng = np.random.default_rng(seed)
    shapes = {k: tuple(t.shape) for k, t in model.state_dict().items()}
    params, stats = _mirrored_layout(model.state_dict())
    sd = {}
    for name, path, _ in params:
        is_bn = f"{name.rsplit('.', 1)[0]}.running_mean" in shapes
        if path[-1] == "scale":
            lo, hi = 0.5, 1.5
        elif path[-1] == "bias":
            lo, hi = (-0.5, 0.5) if is_bn else (-0.1, 0.1)
        else:
            b = float(np.sqrt(6.0 / np.prod(shapes[name][1:])))
            lo, hi = -b, b
        sd[name] = torch.from_numpy(rng.uniform(lo, hi, shapes[name]).astype(np.float32))
    for name, path in stats:
        lo, hi = (-0.5, 0.5) if path[-1] == "mean" else (0.5, 1.5)
        sd[name] = torch.from_numpy(rng.uniform(lo, hi, shapes[name]).astype(np.float32))
    return _torch_to_flax_mirrored(sd)


def random_flax_resnet(seed: int, num_classes: int = 2) -> dict:
    """A flax-layout ``AntiSpoofingResNet`` tree from a seed (``_random_flax_mirrored``)."""
    return _random_flax_mirrored(AntiSpoofingResNet(num_classes), seed)


def random_flax_more_features(seed: int, num_classes: int = 2) -> dict:
    """A flax-layout ``MoreFeaturesClassifier`` tree from a seed."""
    return _random_flax_mirrored(MoreFeaturesClassifier(num_classes), seed)


def random_flax_mobilenet_mfca(seed: int, num_classes: int = 2) -> dict:
    """A flax-layout ``MobileNetMFCA`` tree from a seed."""
    return _random_flax_mirrored(MobileNetMFCA(num_classes), seed)


def _opt_kind(optimizer: torch.optim.Optimizer) -> str:
    from audioanalysisdetector_tpu_torch.train.optimizers import RMSprop  # train imports this module

    for cls, kind in ((torch.optim.AdamW, "AdamW"), (torch.optim.Adam, "Adam"),
                      (torch.optim.SGD, "SGD"), (RMSprop, "RMSprop")):
        if isinstance(optimizer, cls):
            if kind == "Adam" and optimizer.param_groups[0]["weight_decay"] > 0:
                return "AdamL2"
            return kind
    raise TypeError(f"no optax layout for {type(optimizer).__name__}")


# optax state name -> the torch optimizer's per-parameter state key
_ADAM = {"mu": "exp_avg", "nu": "exp_avg_sq"}
_MOMENTS = {"Adam": _ADAM, "AdamW": _ADAM, "AdamL2": _ADAM,
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
    if kind in ("Adam", "AdamW", "AdamL2"):
        first = {"count": np.asarray(count, np.int32), **first}
    if kind == "AdamL2":  # add_decayed_weights (no state), then adam's own chain
        return {"0": {}, "1": {"0": first, "1": {}}}
    return {"0": first, **{str(i + 1): {} for i in range(_EMPTY_TAIL[kind])}}


def flax_to_torch_opt_state(
    opt_state: dict, optimizer: torch.optim.Optimizer, model: torch.nn.Module
) -> torch.optim.Optimizer:
    """Load an optax ``opt_state`` tree (the layout above) into
    ``optimizer``, whose parameters are ``model``'s; returns it."""
    kind = _opt_kind(optimizer)
    first = opt_state["1"]["0"] if kind == "AdamL2" else opt_state["0"]
    sd = optimizer.state_dict()
    sd["state"] = {}
    for i, p, _, path, how in _named_params(optimizer, model):
        state = {key: _to_torch(_get(first[optax_name], path), how).to(p.device)
                 for optax_name, key in _MOMENTS[kind].items()}
        if kind in ("Adam", "AdamW", "AdamL2"):
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


# the published SSL-AASIST state dict (github.com/TakHemlata/SSL_Anti-spoofing
# model.py ``Model``, fairseq's ``Wav2Vec2Model`` under ``ssl_model.model``):
# (published prefix, port prefix) for XLS-R, first match wins
_XLSR_PREFIXES = (
    ("feature_extractor.conv_layers.{i}.0.", "conv.convs.{i}."),
    ("feature_extractor.conv_layers.{i}.2.1.", "conv.norms.{i}."),
    ("layer_norm.", "feature_norm."),
    ("post_extract_proj.", "proj."),
    ("encoder.pos_conv.0.bias", "pos_conv.bias"),
    ("encoder.layers.{i}.self_attn.q_proj.", "layers.{i}.q."),
    ("encoder.layers.{i}.self_attn.k_proj.", "layers.{i}.k."),
    ("encoder.layers.{i}.self_attn.v_proj.", "layers.{i}.v."),
    ("encoder.layers.{i}.self_attn.out_proj.", "layers.{i}.out."),
    ("encoder.layers.{i}.self_attn_layer_norm.", "layers.{i}.attn_norm."),
    ("encoder.layers.{i}.fc1.", "layers.{i}.fc1."),
    ("encoder.layers.{i}.fc2.", "layers.{i}.fc2."),
    ("encoder.layers.{i}.final_layer_norm.", "layers.{i}.ffn_norm."),
    ("encoder.layer_norm.", "norm."),
)
# pre-training only: the mask embedding, the quantizer and its projections
_XLSR_UNUSED = ("mask_emb", "quantizer.", "project_q.", "final_proj.")


def fold_weight_norm(g: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The weight that fairseq's ``weight_norm(pos_conv, dim=2)`` computes
    from its ``weight_g`` and ``weight_v``: ``g * v / ||v||``, the norm over
    every axis but the kernel's (2)."""
    return g * v / torch.linalg.vector_norm(v, dim=(0, 1), keepdim=True)


def _port_name(name: str, prefixes=_XLSR_PREFIXES, unused=_XLSR_UNUSED, root: str = "xlsr.") -> str | None:
    """The port's name (under ``root``) of a published front-end tensor
    (``prefixes``: (published, port) pairs, first match wins), or None for
    one inference does not use (``unused``)."""
    if name.startswith(unused):
        return None
    parts = name.split(".")
    index = next((p for p in parts if p.isdigit()), None)
    for pub, port in prefixes:
        pub = pub.format(i=index)
        if name == pub or (pub.endswith(".") and name.startswith(pub)):
            return root + port.format(i=index) + name[len(pub):]
    raise KeyError(f"no port tensor for the published tensor {name!r}")


def ssl_aasist_to_port(state: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """The published SSL-AASIST ``Model.state_dict()`` (``LA_model.pth``; its
    keys under ``module.`` when saved from ``nn.DataParallel``, as the
    published training script saves it) -> ``models.aasist.SSLAASIST``'s.

    XLS-R's tensors map by ``_XLSR_PREFIXES``; the positional conv's weight
    norm (``weight_g`` over dim 2, ``weight_v``) is folded into one weight
    (``fold_weight_norm``); the pre-training tensors are dropped. The back
    end keeps its names under ``aasist.``, but ``encoder.<i>.0.`` (a
    ``Sequential`` of one block there) becomes ``encoder.<i>.``."""
    state = {k.removeprefix("module."): v for k, v in state.items()}
    ssl = "ssl_model.model."
    out: dict[str, torch.Tensor] = {}
    for name, t in state.items():
        if name.startswith(ssl):
            sub = name[len(ssl):]
            if sub in ("encoder.pos_conv.0.weight_g", "encoder.pos_conv.0.weight_v"):
                continue
            port = _port_name(sub)
            if port is not None:
                out[port] = t
        else:
            parts = name.split(".")
            if parts[0] == "encoder" and len(parts) > 3 and parts[2] == "0":
                del parts[2]
            out["aasist." + ".".join(parts)] = t
    pos = ssl + "encoder.pos_conv.0."
    out["xlsr.pos_conv.weight"] = fold_weight_norm(state[pos + "weight_g"], state[pos + "weight_v"])
    return out


# huggingface.co/microsoft/wavlm-large (transformers' ``WavLMModel``):
# (published prefix, port prefix) for the front end, first match wins
_WAVLM_PREFIXES = (
    ("feature_extractor.conv_layers.{i}.conv.", "conv.convs.{i}."),
    ("feature_extractor.conv_layers.{i}.layer_norm.", "conv.norms.{i}."),
    ("feature_projection.layer_norm.", "feature_norm."),
    ("feature_projection.projection.", "proj."),
    ("encoder.pos_conv_embed.conv.bias", "pos_conv.bias"),
    ("encoder.layers.0.attention.rel_attn_embed.", "rel_attn_embed."),
    ("encoder.layers.{i}.attention.q_proj.", "layers.{i}.q."),
    ("encoder.layers.{i}.attention.k_proj.", "layers.{i}.k."),
    ("encoder.layers.{i}.attention.v_proj.", "layers.{i}.v."),
    ("encoder.layers.{i}.attention.out_proj.", "layers.{i}.out."),
    ("encoder.layers.{i}.attention.gru_rel_pos_linear.", "layers.{i}.grep_linear."),
    ("encoder.layers.{i}.attention.gru_rel_pos_const", "layers.{i}.grep_a"),
    ("encoder.layers.{i}.layer_norm.", "layers.{i}.attn_norm."),
    ("encoder.layers.{i}.feed_forward.intermediate_dense.", "layers.{i}.fc1."),
    ("encoder.layers.{i}.feed_forward.output_dense.", "layers.{i}.fc2."),
    ("encoder.layers.{i}.final_layer_norm.", "layers.{i}.ffn_norm."),
    ("encoder.layer_norm.", "norm."),
)
# the positional conv's weight norm, as older and newer transformers save it
_WAVLM_WEIGHT_NORM = (("weight_g", "weight_v"), ("parametrizations.weight.original0",
                                                  "parametrizations.weight.original1"))


def wavlm_to_port(state: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """The published WavLM-Large state dict (huggingface.co/microsoft/
    wavlm-large ``pytorch_model.bin``; its keys under ``wavlm.`` when saved
    from a model with a head, whose own tensors are not taken) ->
    ``models.wav2vec2.WavLM``'s, for ``WavLMMHFA.wavlm``.

    The tensors map by ``_WAVLM_PREFIXES``; layer 0's ``rel_attn_embed`` is
    the one bias embedding; the positional conv's weight norm is folded
    into one weight (``fold_weight_norm``); ``masked_spec_embed``
    (pre-training only) is dropped. A state dict with neither spelling of
    the weight norm (fairseq's ``WavLM-Large.pt``, or one already folded)
    raises KeyError."""
    if any(k.startswith("wavlm.") for k in state):
        state = {k[len("wavlm."):]: v for k, v in state.items() if k.startswith("wavlm.")}
    pos = "encoder.pos_conv_embed.conv."
    found = next(((pos + g, pos + v) for g, v in _WAVLM_WEIGHT_NORM if pos + g in state), None)
    if found is None:
        expected = " or ".join(f"{pos}{g} / {v}" for g, v in _WAVLM_WEIGHT_NORM)
        raise KeyError(f"no weight-normed positional conv: expected {expected} (the transformers "
                       "WavLMModel names; fairseq's WavLM-Large.pt format is not supported)")
    g, v = found
    out = {"pos_conv.weight": fold_weight_norm(state[g], state[v])}
    for name, t in state.items():
        if name not in (g, v):
            port = _port_name(name, _WAVLM_PREFIXES, ("masked_spec_embed",), "")
            if port is not None:
                out[port] = t
    return out


# huggingface.co/facebook/w2v-bert-2.0 (transformers' ``Wav2Vec2BertModel``):
# (published prefix, port prefix), first match wins
_W2VBERT_PREFIXES = (
    ("feature_projection.layer_norm.", "feature_norm."),
    ("feature_projection.projection.", "proj."),
    ("encoder.layers.{i}.ffn1_layer_norm.", "layers.{i}.ffn1_norm."),
    ("encoder.layers.{i}.ffn1.intermediate_dense.", "layers.{i}.ffn1.fc1."),
    ("encoder.layers.{i}.ffn1.output_dense.", "layers.{i}.ffn1.fc2."),
    ("encoder.layers.{i}.self_attn_layer_norm.", "layers.{i}.attn_norm."),
    ("encoder.layers.{i}.self_attn.linear_q.", "layers.{i}.q."),
    ("encoder.layers.{i}.self_attn.linear_k.", "layers.{i}.k."),
    ("encoder.layers.{i}.self_attn.linear_v.", "layers.{i}.v."),
    ("encoder.layers.{i}.self_attn.linear_out.", "layers.{i}.out."),
    ("encoder.layers.{i}.self_attn.distance_embedding.", "layers.{i}.distance_embedding."),
    ("encoder.layers.{i}.conv_module.layer_norm.", "layers.{i}.conv_module.norm."),
    ("encoder.layers.{i}.conv_module.pointwise_conv1.", "layers.{i}.conv_module.pointwise1."),
    ("encoder.layers.{i}.conv_module.depthwise_conv.", "layers.{i}.conv_module.depthwise."),
    ("encoder.layers.{i}.conv_module.depthwise_layer_norm.", "layers.{i}.conv_module.depthwise_norm."),
    ("encoder.layers.{i}.conv_module.pointwise_conv2.", "layers.{i}.conv_module.pointwise2."),
    ("encoder.layers.{i}.ffn2_layer_norm.", "layers.{i}.ffn2_norm."),
    ("encoder.layers.{i}.ffn2.intermediate_dense.", "layers.{i}.ffn2.fc1."),
    ("encoder.layers.{i}.ffn2.output_dense.", "layers.{i}.ffn2.fc2."),
    ("encoder.layers.{i}.final_layer_norm.", "layers.{i}.final_norm."),
)


def w2vbert_to_port(state: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """The published w2v-BERT 2.0 state dict (huggingface.co/facebook/
    w2v-bert-2.0 ``model.safetensors`` as a state dict; its keys under
    ``wav2vec2_bert.`` when saved from a model with a head, whose own
    tensors are not taken) -> ``models.w2v_bert.W2VBert``'s, for
    ``W2VBertMHFA.w2vbert``.

    The tensors map by ``_W2VBERT_PREFIXES``; the pointwise convs' weights
    lose their kernel axis of 1 (bias-free Linears in the port);
    ``masked_spec_embed`` (pre-training only) is dropped. A tensor of a
    module the port does not build (an adapter, an intermediate FFN) raises
    KeyError."""
    prefix = "wav2vec2_bert."
    if any(k.startswith(prefix) for k in state):
        state = {k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)}
    out = {}
    for name, t in state.items():
        port = _port_name(name, _W2VBERT_PREFIXES, ("masked_spec_embed",), "")
        if port is None:
            continue
        if ".pointwise" in port:
            t = t.squeeze(-1)
        out[port] = t
    return out


# huggingface.co/openai/whisper-large-v3 (transformers' ``WhisperEncoder``):
# (published prefix, port prefix), first match wins
_WHISPER_PREFIXES = (
    ("conv1.", "conv1."),
    ("conv2.", "conv2."),
    ("embed_positions.weight", "positions"),
    ("layers.{i}.self_attn.q_proj.", "layers.{i}.q."),
    ("layers.{i}.self_attn.k_proj.", "layers.{i}.k."),
    ("layers.{i}.self_attn.v_proj.", "layers.{i}.v."),
    ("layers.{i}.self_attn.out_proj.", "layers.{i}.out."),
    ("layers.{i}.self_attn_layer_norm.", "layers.{i}.attn_norm."),
    ("layers.{i}.fc1.", "layers.{i}.fc1."),
    ("layers.{i}.fc2.", "layers.{i}.fc2."),
    ("layers.{i}.final_layer_norm.", "layers.{i}.ffn_norm."),
    ("layer_norm.", "norm."),
)


def whisper_to_port(state: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """The published Whisper large-v3 encoder (huggingface.co/openai/
    whisper-large-v3 ``model.safetensors`` as a state dict: its keys under
    ``model.encoder.`` in ``WhisperForConditionalGeneration``, under
    ``encoder.`` in ``WhisperModel``, bare in ``WhisperEncoder``; the
    decoder's and ``proj_out``'s tensors are not taken) ->
    ``models.whisper.WhisperEncoder``'s, for ``WhisperMHFA.whisper``.

    The tensors map by ``_WHISPER_PREFIXES``; ``embed_positions.weight`` is
    the positions' table. A tensor of a module the port does not build
    raises KeyError."""
    for prefix in ("model.encoder.", "encoder."):
        if any(k.startswith(prefix) for k in state):
            state = {k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)}
            break
    return {_port_name(name, _WHISPER_PREFIXES, (), ""): t for name, t in state.items()}


# huggingface.co/mistralai/Voxtral-Mini-3B-2507 (transformers'
# ``VoxtralForConditionalGeneration``) past its audio tower: (published
# prefix, port prefix), first match wins
_VOXTRAL_PREFIXES = (
    ("multi_modal_projector.", "projector."),
    ("language_model.model.embed_tokens.", "embed."),
    ("language_model.model.layers.{i}.input_layernorm.", "layers.{i}.attn_norm."),
    ("language_model.model.layers.{i}.self_attn.q_proj.", "layers.{i}.q."),
    ("language_model.model.layers.{i}.self_attn.k_proj.", "layers.{i}.k."),
    ("language_model.model.layers.{i}.self_attn.v_proj.", "layers.{i}.v."),
    ("language_model.model.layers.{i}.self_attn.o_proj.", "layers.{i}.o."),
    ("language_model.model.layers.{i}.post_attention_layernorm.", "layers.{i}.ffn_norm."),
    ("language_model.model.layers.{i}.mlp.gate_proj.", "layers.{i}.gate."),
    ("language_model.model.layers.{i}.mlp.up_proj.", "layers.{i}.up."),
    ("language_model.model.layers.{i}.mlp.down_proj.", "layers.{i}.down."),
    ("language_model.model.norm.", "norm."),
    ("language_model.lm_head.", "lm_head."),
    ("lm_head.", "lm_head."),
)


def voxtral_to_port(state: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """The published Voxtral-Mini-3B (huggingface.co/mistralai/
    Voxtral-Mini-3B-2507 ``model.safetensors`` as a state dict, under
    transformers' names: ``audio_tower.*``, ``multi_modal_projector.*``,
    ``language_model.model.*``, ``language_model.lm_head`` or ``lm_head``)
    -> ``models.voxtral.VoxtralDetector``'s weights. The audio tower maps
    as ``whisper_to_port`` maps Whisper's encoder, under ``whisper.``; the
    prompt's ids are no published tensor and are not given. A tensor of a
    module the port does not build raises KeyError."""
    tower = {k[len("audio_tower."):]: v for k, v in state.items() if k.startswith("audio_tower.")}
    out = {"whisper." + k: v for k, v in whisper_to_port(tower).items()}
    out.update({_port_name(name, _VOXTRAL_PREFIXES, (), ""): t for name, t in state.items()
                if not name.startswith("audio_tower.")})
    return out
