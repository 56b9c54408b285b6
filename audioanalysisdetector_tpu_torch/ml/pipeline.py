"""``Pipeline`` with ``step__param`` routing and a cache of fitted transformer prefixes.

sklearn's ``Pipeline(steps, memory=)``: ``fit`` fits each transformer on
the output of the steps before it and the last step on the output of all
of them; ``predict`` and ``decision_function`` run the transforms, then
the last step. Between steps the rows stay on the device.

``memory`` (a ``FitCache``, a directory, or ``None``) does joblib.Memory's
job in the JAX package: a fitted transformer prefix is reused whenever the
same training rows come back with the same prefix parameters, so in a grid
search each (scaler, reducer) is fit once per fold, not once per classifier
candidate. The key is a digest of the pipeline's input rows and labels,
each prefix step's class and parameters and the device. A ``FitCache``
keeps the fitted states and transformed rows in memory and as ``.npz``
files under its directory, where a later run finds them; clones of a
pipeline share the ``FitCache`` object they were given (a directory alone
gives each fit a new one, so only the files are shared).
"""

from __future__ import annotations

import hashlib
import os
from collections import OrderedDict

import numpy as np
import torch

from audioanalysisdetector_tpu_torch.ml._base import BaseEstimator, as_tensor, labels_of, to_numpy

# in-memory entries a FitCache keeps (each a fold's transformed rows)
CACHE_ENTRIES = 256


class FitCache:
    """Fitted prefix states and outputs by key: an in-memory LRU in front
    of ``.npz`` files in ``location``."""

    def __init__(self, location: str):
        self.location = location
        self.entries: OrderedDict[str, tuple[dict, torch.Tensor]] = OrderedDict()
        os.makedirs(location, exist_ok=True)

    def _path(self, key: str) -> str:
        return os.path.join(self.location, f"prefix_{key}.npz")

    def get(self, key: str, device) -> tuple[dict, torch.Tensor] | None:
        if key in self.entries:
            self.entries.move_to_end(key)
            return self.entries[key]
        path = self._path(key)
        if not os.path.exists(path):
            return None
        with np.load(path) as z:
            state = {k[len("state_"):]: z[k] for k in z.files if k.startswith("state_")}
            out = as_tensor(z["output"], device)
        self._remember(key, (state, out))
        return state, out

    def put(self, key: str, state: dict, out: torch.Tensor) -> None:
        tmp = self._path(key) + ".tmp.npz"
        np.savez(tmp, output=to_numpy(out), **{f"state_{k}": v for k, v in state.items()})
        os.replace(tmp, self._path(key))
        self._remember(key, (state, out))

    def _remember(self, key: str, entry) -> None:
        self.entries[key] = entry
        while len(self.entries) > CACHE_ENTRIES:
            self.entries.popitem(last=False)


def _digest_rows(X, y) -> "hashlib._Hash":
    h = hashlib.sha1()
    x = to_numpy(X) if isinstance(X, torch.Tensor) else np.ascontiguousarray(X, dtype=np.float64)
    h.update(repr(x.shape).encode())
    h.update(np.ascontiguousarray(x, dtype=np.float64).tobytes())
    h.update(np.asarray(labels_of(y)).astype(str).tobytes() if y is not None else b"")
    return h


class Pipeline(BaseEstimator):
    def __init__(self, steps: list, *, memory: "FitCache | str | None" = None):
        self.steps = steps
        self.memory = memory

    @property
    def named_steps(self) -> dict:
        return dict(self.steps)

    @property
    def _final_estimator(self):
        return self.steps[-1][1]

    def get_params(self, deep: bool = True) -> dict:
        out = {"memory": self.memory, "steps": self.steps}
        if deep:
            for name, est in self.steps:
                out[name] = est
                out.update((f"{name}__{k}", v) for k, v in est.get_params(deep=True).items())
        return out

    def set_params(self, **params) -> "Pipeline":
        steps = dict(self.steps)
        for key, value in params.items():
            name, sep, sub = key.partition("__")
            if key in ("memory", "steps"):
                setattr(self, key, value)
            elif sep and name in steps:
                steps[name].set_params(**{sub: value})
            elif name in steps:
                self.steps = [(n, value if n == name else e) for n, e in self.steps]
                steps[name] = value
            else:
                raise ValueError(f"invalid parameter {key!r} for Pipeline")
        return self

    def _device(self):
        return torch.device(self.steps[0][1].device)

    def fit(self, X, y) -> "Pipeline":
        device = self._device()
        cache = FitCache(self.memory) if isinstance(self.memory, str) else self.memory
        digest = _digest_rows(X, y) if cache is not None else None
        Xt = as_tensor(X, device)
        for name, step in self.steps[:-1]:
            if cache is None:
                Xt = step._fit_transform_t(Xt)
                continue
            digest.update(repr((name, type(step).__name__, sorted(step.get_params().items()), device.type)).encode())
            key = digest.copy().hexdigest()
            hit = cache.get(key, device)
            if hit is not None:
                step.set_state(hit[0])
                Xt = hit[1]
            else:
                Xt = step._fit_transform_t(Xt)
                cache.put(key, step.get_state(), Xt)
        final = self._final_estimator
        if hasattr(final, "_fit_t"):
            final._fit_t(Xt, y)
        else:
            final.fit(Xt, y)
        return self

    def _transform_t(self, X) -> torch.Tensor:
        Xt = as_tensor(X, self._device())
        for _, step in self.steps[:-1]:
            Xt = step._transform_t(Xt)
        return Xt

    def predict(self, X) -> np.ndarray:
        return self._final_estimator._predict_t(self._transform_t(X))

    def decision_function(self, X) -> np.ndarray:
        return self._final_estimator.decision_function(self._transform_t(X))
