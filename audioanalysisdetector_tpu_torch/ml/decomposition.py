"""``PCA`` and ``FastICA`` in torch float64 on the device.

sklearn 1.9's arithmetic (``decomposition/_pca.py``, ``_fastica.py``):

- ``PCA``: ``svd_solver="auto"`` picks ``covariance_eigh`` where
  ``n_features <= 1000`` and ``n_samples >= 10 * n_features`` (every fit
  of the classical path at its reference scale): ``eigh`` of the
  covariance, eigenvalues descending and clipped at 0. It picks ``full``
  (the SVD of the centred data) where ``max(shape) <= 500``. Where sklearn
  would go ``randomized`` (tall-ish data past 500 rows), the port stays
  exact and takes the full SVD: the randomized solver's answer is an
  approximation of this one. Signs follow ``svd_flip`` with
  ``u_based_decision=False`` (each component's largest entry positive).
- ``FastICA``: the defaults ``algorithm="parallel"``, ``fun="logcosh"``,
  ``whiten="unit-variance"``, ``whiten_solver="svd"`` (``u *= sign(u[0])``),
  ``max_iter=200``, ``tol=1e-4``; ``w_init`` is
  ``RandomState(random_state).normal(size=(k, k))``, drawn on the host as
  sklearn draws it; the symmetric decorrelation goes through ``eigh``.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from audioanalysisdetector_tpu_torch.ml._base import BaseEstimator, TransformerMixin, check_random_state


class ConvergenceWarning(UserWarning):
    """sklearn's ``exceptions.ConvergenceWarning`` role."""


def _svd_flip_rows(v: torch.Tensor, u: torch.Tensor | None = None):
    """``svd_flip(u, v, u_based_decision=False)``: each row of ``v`` signed
    so that its largest-magnitude entry is positive (``u``'s columns too)."""
    idx = torch.argmax(v.abs(), dim=1)
    signs = torch.sign(v.gather(1, idx[:, None]))[:, 0]
    if u is not None:
        u = u * signs[None, :]
    return u, v * signs[:, None]


class PCA(TransformerMixin, BaseEstimator):
    _state_keys = ("mean_", "components_", "explained_variance_", "explained_variance_ratio_",
                   "singular_values_", "noise_variance_", "n_components_", "n_samples_")

    def __init__(self, n_components: int | None = None, *, random_state=None,
                 device: str | torch.device = "cuda"):
        self.n_components = n_components
        self.random_state = random_state
        self.device = device

    def _solver(self, n_samples: int, n_features: int) -> str:
        if n_features <= 1_000 and n_samples >= 10 * n_features:
            return "covariance_eigh"
        return "full"

    def _fit_transform_t(self, X: torch.Tensor) -> torch.Tensor:
        n_samples, n_features = X.shape
        k = min(X.shape) if self.n_components is None else int(self.n_components)
        if not 0 <= k <= min(n_samples, n_features):
            raise ValueError(f"n_components={k} must be between 0 and min(n_samples, n_features)={min(X.shape)}")
        self._fit_svd_solver = self._solver(n_samples, n_features)
        self.mean_ = X.mean(0)
        U = None
        if self._fit_svd_solver == "full":
            U, S, Vt = torch.linalg.svd(X - self.mean_, full_matrices=False)
            explained = S * S / (n_samples - 1)
        else:
            C = X.T @ X
            C = C - n_samples * self.mean_[:, None] * self.mean_[None, :]
            C = C / (n_samples - 1)
            evals, evecs = torch.linalg.eigh(C)
            evals = torch.flip(evals, (0,)).clamp_min(0.0)
            explained = evals
            S = torch.sqrt(evals * (n_samples - 1))
            Vt = torch.flip(evecs, (1,)).T
        U, Vt = _svd_flip_rows(Vt, U)
        total = explained.sum()
        self.noise_variance_ = float(explained[k:].mean()) if k < min(n_features, n_samples) else 0.0
        self.n_samples_ = n_samples
        self.n_features_in_ = n_features
        self.n_components_ = k
        self.components_ = Vt[:k].contiguous()
        self.explained_variance_ = explained[:k].clone()
        self.explained_variance_ratio_ = explained[:k] / total
        self.singular_values_ = S[:k].clone()
        if U is not None:
            return U[:, :k] * S[:k]
        return self._transform_t(X)

    def _transform_t(self, X: torch.Tensor) -> torch.Tensor:
        return X @ self.components_.T - (self.mean_[None, :] @ self.components_.T)


def _sym_decorrelation(W: torch.Tensor) -> torch.Tensor:
    """``W <- (W W^T)^{-1/2} W`` through ``eigh``, eigenvalues clipped at
    float64's tiny."""
    s, u = torch.linalg.eigh(W @ W.T)
    s = s.clamp_min(np.finfo(np.float64).tiny)
    return (u * (1.0 / torch.sqrt(s))) @ u.T @ W


class FastICA(TransformerMixin, BaseEstimator):
    _state_keys = ("components_", "mixing_", "mean_", "whitening_", "n_iter_")

    def __init__(self, n_components: int | None = None, *, max_iter: int = 200, tol: float = 1e-4,
                 random_state=None, device: str | torch.device = "cuda"):
        self.n_components = n_components
        self.max_iter = max_iter
        self.tol = tol
        self.random_state = random_state
        self.device = device

    def _fit_transform_t(self, X: torch.Tensor) -> torch.Tensor:
        n_samples, n_features = X.shape
        k = min(n_samples, n_features) if self.n_components is None else int(self.n_components)
        if k > min(n_samples, n_features):
            k = min(n_samples, n_features)
            warnings.warn(f"n_components is too large: it will be set to {k}")
        rng = check_random_state(self.random_state)
        XT = X.T
        mean = XT.mean(-1)
        XT = XT - mean[:, None]
        u, d, _ = torch.linalg.svd(XT, full_matrices=False)
        u = u * torch.sign(u[0])
        K = (u / d).T[:k]
        X1 = (K @ XT) * np.sqrt(n_samples)
        w_init = torch.as_tensor(rng.normal(size=(k, k)), dtype=torch.float64, device=X.device)
        W = _sym_decorrelation(w_init)
        p = float(X1.shape[1])
        for ii in range(self.max_iter):
            gwtx = torch.tanh(W @ X1)
            g_wtx = (1.0 - gwtx * gwtx).mean(-1)
            W1 = _sym_decorrelation(gwtx @ X1.T / p - g_wtx[:, None] * W)
            lim = float(torch.max(torch.abs(torch.abs((W1 * W).sum(-1)) - 1.0)))
            W = W1
            if lim < self.tol:
                break
        else:
            warnings.warn("FastICA did not converge. Consider increasing tolerance or the maximum number "
                          "of iterations.", ConvergenceWarning)
        self.n_iter_ = ii + 1
        S = ((W @ K) @ XT).T
        S_std = S.std(0, correction=0, keepdim=True)
        S = S / S_std
        W = W / S_std.T
        self.components_ = W @ K
        self.mean_ = mean
        self.whitening_ = K
        self.mixing_ = torch.linalg.pinv(self.components_)
        self._unmixing = W
        self.n_features_in_ = n_features
        return S

    def _transform_t(self, X: torch.Tensor) -> torch.Tensor:
        return (X - self.mean_) @ self.components_.T
