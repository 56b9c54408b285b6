"""Estimator plumbing shared by ``ml/``: parameters, cloning, tensors.

sklearn's ``BaseEstimator`` contract, without sklearn: the constructor's
keyword arguments are the parameters (``get_params`` reads them back off
the instance by the signature's names), ``set_params`` takes
``step__param`` names for nested estimators, and ``clone`` builds a new
unfitted instance from the parameters. Every estimator computes in float64
on its ``device``; a CUDA device without a card raises, as torch does.
"""

from __future__ import annotations

import inspect

import numpy as np
import torch


class BaseEstimator:
    """Parameters are the ``__init__`` keyword arguments, kept as attributes."""

    @classmethod
    def _param_names(cls) -> list[str]:
        sig = inspect.signature(cls.__init__)
        return sorted(p.name for p in sig.parameters.values() if p.name != "self" and p.kind != p.VAR_KEYWORD)

    def get_params(self, deep: bool = True) -> dict:
        out = {}
        for name in self._param_names():
            value = getattr(self, name)
            if deep and hasattr(value, "get_params") and not isinstance(value, type):
                out.update((f"{name}__{k}", v) for k, v in value.get_params().items())
            out[name] = value
        return out

    def set_params(self, **params) -> "BaseEstimator":
        valid = self.get_params(deep=True)
        nested: dict[str, dict] = {}
        for key, value in params.items():
            name, sep, sub = key.partition("__")
            if name not in valid:
                raise ValueError(f"invalid parameter {name!r} for estimator {type(self).__name__}")
            if sep:
                nested.setdefault(name, {})[sub] = value
            else:
                setattr(self, name, value)
        for name, sub_params in nested.items():
            getattr(self, name).set_params(**sub_params)
        return self

    def __repr__(self) -> str:
        args = ", ".join(f"{k}={v!r}" for k, v in self.get_params(deep=False).items())
        return f"{type(self).__name__}({args})"


def clone(estimator):
    """A new unfitted estimator with the same parameters (nested estimators
    and lists of ``(name, estimator)`` steps cloned too)."""
    if isinstance(estimator, (list, tuple)):
        return type(estimator)(clone(e) for e in estimator)
    if not hasattr(estimator, "get_params"):
        return estimator
    params = {k: clone(v) if hasattr(v, "get_params") or isinstance(v, (list, tuple)) else v
              for k, v in estimator.get_params(deep=False).items()}
    return type(estimator)(**params)


def check_random_state(seed) -> np.random.RandomState:
    """sklearn's ``check_random_state``: None is numpy's global RandomState,
    an int seeds a new one, a RandomState passes through."""
    if seed is None:
        return np.random.mtrand._rand
    if isinstance(seed, np.random.RandomState):
        return seed
    return np.random.RandomState(seed)


def as_tensor(X, device) -> torch.Tensor:
    """``X`` as a float64 tensor on ``device`` (a copy only when needed)."""
    if isinstance(X, torch.Tensor):
        return X.to(device=device, dtype=torch.float64)
    return torch.as_tensor(np.asarray(X, dtype=np.float64), device=device)


def to_numpy(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def labels_of(y) -> np.ndarray:
    """``y`` as a 1-D host array (labels are classified on the host)."""
    if isinstance(y, torch.Tensor):
        y = y.detach().cpu().numpy()
    return np.asarray(y).ravel()


class TransformerMixin:
    """Numpy-facing ``fit`` / ``fit_transform`` / ``transform`` over the
    estimator's ``_fit_transform_t`` / ``_transform_t`` (tensors on its
    device), and its fitted state as arrays (``get_state`` / ``set_state``,
    the pipeline cache's ``.npz`` contents)."""

    _state_keys: tuple[str, ...] = ()

    def fit(self, X, y=None):
        self._fit_transform_t(as_tensor(X, self.device))
        return self

    def fit_transform(self, X, y=None) -> np.ndarray:
        return to_numpy(self._fit_transform_t(as_tensor(X, self.device)))

    def transform(self, X) -> np.ndarray:
        return to_numpy(self._transform_t(as_tensor(X, self.device)))

    def get_state(self) -> dict:
        out = {}
        for k in self._state_keys:
            v = getattr(self, k)
            if v is not None:
                out[k] = to_numpy(v) if isinstance(v, torch.Tensor) else np.asarray(v)
        return out

    def set_state(self, state: dict):
        for k in self._state_keys:
            v = state.get(k)
            setattr(self, k, None if v is None else as_tensor(v, self.device) if np.ndim(v) else np.asarray(v).item())
        return self
