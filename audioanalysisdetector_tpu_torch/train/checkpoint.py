"""Checkpoints in the JAX package's format: flax ``.msgpack`` payloads, both ways.

Counterpart of the JAX package's ``train/checkpoint.py``. A checkpoint is
the flax msgpack document ``{step, params, batch_stats, opt_state}`` plus,
with ``metadata``, a JSON sidecar ``<path>.json``; params, BatchNorm
statistics and optimizer state are in the flax / optax layout
(``convert.py``). So a run the port starts, the JAX package scores and
resumes, and the reverse; both packages' ``score --checkpoint`` read it.
Reading and writing go through the port's own msgpack codec
(``train/_msgpack.py``): neither ``msgpack`` nor ``flax`` is needed.

The models: ``CNNBiLSTMHybrid``, ``AntiSpoofingResNet``,
``MoreFeaturesClassifier`` and ``MobileNetMFCA`` (with their BatchNorm
statistics), and ``BiLSTMClassifier`` (an empty ``batch_stats``).

``save_checkpoint_orbax`` / ``restore_checkpoint_orbax`` keep the JAX
package's names for its sharding-aware backend, but write
``torch.distributed.checkpoint`` (DCP) directories, not orbax's: each rank
of a process group calls them and DCP writes replicated tensors once. Only
the port reads them; ``.msgpack`` stays the one format both packages read.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from audioanalysisdetector_tpu_torch.convert import (
    MIRRORED,
    _flax_to_torch_mirrored,
    _torch_to_flax_mirrored,
    flax_to_torch_bilstm_classifier,
    flax_to_torch_cnn_bilstm,
    flax_to_torch_opt_state,
    torch_to_flax_bilstm_classifier,
    torch_to_flax_cnn_bilstm,
    torch_to_flax_opt_state,
)
from audioanalysisdetector_tpu_torch.models.bilstm_classifier import BiLSTMClassifier
from audioanalysisdetector_tpu_torch.models.cnn_bilstm import CNNBiLSTMHybrid
from audioanalysisdetector_tpu_torch.train._msgpack import MsgpackFormatError, msgpack_restore, to_bytes

__all__ = [
    "MsgpackFormatError",
    "load_payload",
    "restore_checkpoint",
    "restore_checkpoint_orbax",
    "restore_params",
    "save_checkpoint",
    "save_checkpoint_orbax",
    "save_params",
]


def _converters(model: torch.nn.Module):
    """(torch -> flax, flax -> torch) of the model's type."""
    if isinstance(model, CNNBiLSTMHybrid):
        return torch_to_flax_cnn_bilstm, flax_to_torch_cnn_bilstm
    if isinstance(model, BiLSTMClassifier):
        return (lambda sd: {**torch_to_flax_bilstm_classifier(sd), "batch_stats": {}},
                flax_to_torch_bilstm_classifier)
    if isinstance(model, MIRRORED):
        return _torch_to_flax_mirrored, _flax_to_torch_mirrored
    raise TypeError(f"no checkpoint layout for {type(model).__name__}")


def _variables(model: torch.nn.Module) -> dict:
    """The model's ``{"params", "batch_stats"}`` in the flax layout."""
    return _converters(model)[0](model.state_dict())


def _load_variables(model: torch.nn.Module, variables: dict, *, strict: bool = True) -> None:
    """Load flax-layout variables into ``model`` (shapes must fit: a wrong
    one raises, as flax's restore into a template does)."""
    model.load_state_dict(_converters(model)[1](variables), strict=strict)


def _host(tree):
    """The tree as the JAX package's ``_to_host`` leaves it: its copy through
    ``jax.tree_util`` orders every dict's keys (the file's bytes follow)."""
    if isinstance(tree, dict):
        return {k: _host(tree[k]) for k in sorted(tree)}
    return tree


def _write(path: str, data: bytes) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)


def save_checkpoint(path: str, state, *, metadata: dict | None = None) -> None:
    """Serialize a ``TrainState`` to ``path`` (.msgpack), as the JAX
    package's ``save_checkpoint`` serializes its own."""
    variables = _variables(state.model)
    payload = {
        "step": np.asarray(state.step, np.int32),
        "params": _host(variables["params"]),
        "batch_stats": _host(variables["batch_stats"]),
        "opt_state": _host(torch_to_flax_opt_state(state.optimizer, state.model)),
    }
    _write(path, to_bytes(payload))
    if metadata is not None:
        with open(path + ".json", "w") as f:
            json.dump(metadata, f, indent=2, default=float)


def load_payload(path: str) -> dict:
    """Read a checkpoint WITHOUT a template: the raw payload dict."""
    with open(path, "rb") as f:
        return msgpack_restore(f.read())


def restore_checkpoint(path: str, state):
    """Restore a checkpoint of either package into ``state`` (its model and
    optimizer are the template: the parameters, statistics and moments must
    fit them) and return it."""
    payload = load_payload(path)
    _load_variables(state.model, {"params": payload["params"], "batch_stats": payload.get("batch_stats")})
    flax_to_torch_opt_state(payload["opt_state"], state.optimizer, state.model)
    state.step = int(np.asarray(payload["step"]))
    return state


def save_params(path: str, model: torch.nn.Module) -> None:
    """The model's flax ``params`` tree alone (the JAX ``save_params``)."""
    _write(path, to_bytes(_host(_variables(model)["params"])))


def restore_params(path: str, model: torch.nn.Module) -> torch.nn.Module:
    """Load a ``save_params`` file of either package into ``model``; its
    BatchNorm statistics stay as they are."""
    with open(path, "rb") as f:
        params = msgpack_restore(f.read())
    _load_variables(model, {"params": params}, strict=False)
    return model


def _dcp_state_dict(state, with_optimizer: bool) -> dict:
    """``{step, model[, optimizer]}`` in DCP's flat naming."""
    from torch.distributed.checkpoint.state_dict import get_model_state_dict, get_optimizer_state_dict

    sd = {"step": torch.tensor(state.step, dtype=torch.int64), "model": get_model_state_dict(state.model)}
    if with_optimizer:
        sd["optimizer"] = get_optimizer_state_dict(state.model, state.optimizer)
    return sd


def save_checkpoint_orbax(directory: str, state, *, step: int | None = None) -> str:
    """Persist ``state`` as a DCP checkpoint in ``<directory>/step_<step>``
    (the JAX package's layout of its orbax steps) and return that path.
    Every rank of a process group calls it with the same directory. An
    optimizer that has not stepped yet holds its initial state and is
    written without one."""
    import torch.distributed.checkpoint as dcp

    step = int(state.step) if step is None else step
    path = os.path.join(os.path.abspath(directory), f"step_{step}")
    dcp.save(_dcp_state_dict(state, bool(state.optimizer.state)), checkpoint_id=path)
    return path


def restore_checkpoint_orbax(path: str, state):
    """Restore a ``save_checkpoint_orbax`` directory into ``state`` (its
    model and optimizer are the template) and return it."""
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint.state_dict import set_model_state_dict, set_optimizer_state_dict

    path = os.path.abspath(path)
    keys = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
    with_optimizer = any(k.startswith("optimizer.") for k in keys)
    sd = _dcp_state_dict(state, with_optimizer)
    dcp.load(sd, checkpoint_id=path)
    set_model_state_dict(state.model, sd["model"])
    if with_optimizer:
        set_optimizer_state_dict(state.model, state.optimizer, sd["optimizer"])
    else:
        state.optimizer.state.clear()
    state.step = int(sd["step"])
    return state
