"""Diagonal-covariance GMM scoring (PyTorch).

Counterpart of the scoring half of the JAX package's ``models/gmm.py``
(the reference's sklearn GMM subsystem, reference/ASV_dl_func.py:1132-1203):
per-component log-densities, per-frame log-likelihoods, the mean-frame
log-likelihood ratio and its padding-masked form. Densities use the JAX
package's quadratic expansion
``(x - mu)^2 / var = x^2 (1/var) - 2 x (mu/var) + mu^2/var`` (two GEMMs),
so both packages cancel the same terms in fp32. EM, k-means seeding and MAP
adaptation wait for ROADMAP Queue 1 step 8.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

_LOG2PI = float(np.log(2.0 * np.pi))


@dataclass(frozen=True)
class DiagGMM:
    """weights (K,), means (K, D), variances (K, D)."""

    weights: torch.Tensor
    means: torch.Tensor
    variances: torch.Tensor

    @property
    def n_components(self) -> int:
        return self.means.shape[0]


def component_log_prob(x: torch.Tensor, gmm: DiagGMM) -> torch.Tensor:
    """Per-component Gaussian log-density: (..., D) -> (..., K)."""
    inv_var = 1.0 / gmm.variances  # (K, D)
    quad = (
        (x * x) @ inv_var.T
        - 2.0 * (x @ (gmm.means * inv_var).T)
        + torch.sum(gmm.means * gmm.means * inv_var, dim=-1)
    )
    log_det = torch.sum(torch.log(gmm.variances), dim=-1)  # (K,)
    return -0.5 * (x.shape[-1] * _LOG2PI + log_det + quad)


def log_weighted(x: torch.Tensor, gmm: DiagGMM) -> torch.Tensor:
    return component_log_prob(x, gmm) + torch.log(gmm.weights)


def score_samples(x: torch.Tensor, gmm: DiagGMM) -> torch.Tensor:
    """Per-frame log-likelihood: (..., D) -> (...)."""
    return torch.logsumexp(log_weighted(x, gmm), dim=-1)


def score(x: torch.Tensor, gmm: DiagGMM) -> torch.Tensor:
    """Mean per-frame log-likelihood (sklearn ``.score`` semantics)."""
    return score_samples(x, gmm).mean(dim=-1)


def predict_proba(x: torch.Tensor, gmm: DiagGMM) -> torch.Tensor:
    return torch.softmax(log_weighted(x, gmm), dim=-1)


def compute_llr(x: torch.Tensor, gmm1: DiagGMM, gmm2: DiagGMM) -> torch.Tensor:
    """Mean-LL ratio, the reference's ``compute_llr``
    (reference/ASV_dl_func.py:1200-1203): (..., T, D) -> (...)."""
    return score(x, gmm1) - score(x, gmm2)


def masked_llr(x: torch.Tensor, mask: torch.Tensor, gmm1: DiagGMM, gmm2: DiagGMM) -> torch.Tensor:
    """LLR over valid frames only: x (..., T, D), mask (..., T) boolean
    (the reference scorer's padding semantics, reference/ASV_dl_func.py:1486-1489);
    a row with no valid frame gives 0."""
    diff = score_samples(x, gmm1) - score_samples(x, gmm2)  # (..., T)
    m = mask.to(diff.dtype)
    return torch.sum(diff * m, dim=-1) / torch.clamp(torch.sum(m, dim=-1), min=1.0)


def to_numpy(gmm: DiagGMM) -> dict[str, np.ndarray]:
    return {
        "weights": gmm.weights.detach().cpu().numpy(),
        "means": gmm.means.detach().cpu().numpy(),
        "variances": gmm.variances.detach().cpu().numpy(),
    }


def from_numpy(d: dict[str, np.ndarray], *, device: str | torch.device = "cuda") -> DiagGMM:
    """float32 tensors on ``device`` (the card unless the caller names another)."""
    return DiagGMM(*(
        torch.as_tensor(np.asarray(d[k], np.float32)).to(device) for k in ("weights", "means", "variances")
    ))
