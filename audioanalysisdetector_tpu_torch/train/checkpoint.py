"""Checkpoints in the JAX package's format: flax ``.msgpack`` payloads, both ways.

Counterpart of the JAX package's ``train/checkpoint.py``. A checkpoint is
the flax msgpack document ``{step, params, batch_stats, opt_state}`` plus,
with ``metadata``, a JSON sidecar ``<path>.json``; params, BatchNorm
statistics and optimizer state are in the flax / optax layout
(``convert.py``). So a run the port starts, the JAX package scores and
resumes, and the reverse; both packages' ``score --checkpoint`` read it.
Reading and writing go through the port's own msgpack codec
(``train/_msgpack.py``): neither ``msgpack`` nor ``flax`` is needed.

The models: ``CNNBiLSTMHybrid`` (with its BatchNorm statistics) and
``BiLSTMClassifier`` (an empty ``batch_stats``). Orbax checkpoints have no
counterpart here (``torch.distributed.checkpoint`` is ROADMAP Queue 1
step 9).
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from audioanalysisdetector_tpu_torch.convert import (
    flax_to_torch_bilstm_classifier,
    flax_to_torch_cnn_bilstm,
    flax_to_torch_opt_state,
    torch_to_flax_bilstm_classifier,
    torch_to_flax_cnn_bilstm,
    torch_to_flax_opt_state,
)
from audioanalysisdetector_tpu_torch.models.cnn_bilstm import CNNBiLSTMHybrid
from audioanalysisdetector_tpu_torch.train._msgpack import MsgpackFormatError, msgpack_restore, to_bytes

__all__ = [
    "MsgpackFormatError",
    "load_payload",
    "restore_checkpoint",
    "restore_params",
    "save_checkpoint",
    "save_params",
]


def _variables(model: torch.nn.Module) -> dict:
    """The model's ``{"params", "batch_stats"}`` in the flax layout."""
    sd = model.state_dict()
    if isinstance(model, CNNBiLSTMHybrid):
        return torch_to_flax_cnn_bilstm(sd)
    return {**torch_to_flax_bilstm_classifier(sd), "batch_stats": {}}


def _load_variables(model: torch.nn.Module, variables: dict, *, strict: bool = True) -> None:
    """Load flax-layout variables into ``model`` (shapes must fit: a wrong
    one raises, as flax's restore into a template does)."""
    if isinstance(model, CNNBiLSTMHybrid):
        sd = flax_to_torch_cnn_bilstm(variables)
    else:
        sd = flax_to_torch_bilstm_classifier(variables)
    model.load_state_dict(sd, strict=strict)


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
