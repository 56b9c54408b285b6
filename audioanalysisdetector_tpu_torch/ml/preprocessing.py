"""``StandardScaler`` in torch float64 on the device.

sklearn's ``preprocessing/_data.py`` arithmetic: the mean and the ddof-0
variance of each column (the two-pass variance with its correction term),
and ``scale_ = sqrt(var_)`` with 1 wherever a column is constant within
the two-pass algorithm's rounding bound (``_is_constant_feature``).
"""

from __future__ import annotations

import numpy as np
import torch

from audioanalysisdetector_tpu_torch.ml._base import BaseEstimator, TransformerMixin, as_tensor, to_numpy


class StandardScaler(TransformerMixin, BaseEstimator):
    _state_keys = ("mean_", "var_", "scale_", "n_samples_seen_")

    def __init__(self, *, copy: bool = True, with_mean: bool = True, with_std: bool = True,
                 device: str | torch.device = "cuda"):
        self.copy = copy
        self.with_mean = with_mean
        self.with_std = with_std
        self.device = device

    def _fit_t(self, X: torch.Tensor) -> "StandardScaler":
        n = X.shape[0]
        mean = X.sum(0) / n
        centered = X - mean
        correction = centered.sum(0)
        var = ((centered * centered).sum(0) - correction * correction / n) / n
        eps = np.finfo(np.float64).eps
        constant = var <= n * eps * var + (n * mean * eps) ** 2
        scale = torch.where(constant, torch.ones_like(var), torch.sqrt(var))
        self.mean_ = mean if self.with_mean else None
        self.var_ = var if self.with_std else None
        self.scale_ = scale if self.with_std else None
        self.n_samples_seen_ = n
        self.n_features_in_ = X.shape[1]
        return self

    def _transform_t(self, X: torch.Tensor) -> torch.Tensor:
        if self.with_mean:
            X = X - self.mean_
        if self.with_std:
            X = X / self.scale_
        return X

    def _fit_transform_t(self, X: torch.Tensor) -> torch.Tensor:
        return self._fit_t(X)._transform_t(X)

    def inverse_transform(self, X) -> np.ndarray:
        X = as_tensor(X, self.device)
        if self.with_std:
            X = X * self.scale_
        if self.with_mean:
            X = X + self.mean_
        return to_numpy(X)
