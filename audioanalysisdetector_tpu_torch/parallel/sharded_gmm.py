"""Component-sharded GMM scoring — a model-parallel mesh axis (PyTorch).

Counterpart of the JAX package's ``parallel/sharded_gmm.py``: mixture
components shard over the ``model`` ranks of a 2-D ``DeviceMesh`` while
the batch shards over its ``data`` ranks, and the only communication is
the component-axis logsumexp:

  global logsumexp_K = m + log(sum_model(sum_local exp(lw - m))),
  m = max_model(max_local lw)

two all-reduces over the model group (MAX, then SUM) of two scalars per
frame, whatever K. The JAX function takes the global batch and returns the
global scores; a torch rank holds its own rows, so here each rank passes
its data shard (``train.steps.shard_batch(x, mesh, axis="data")``) and gets
its rows' scores.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from audioanalysisdetector_tpu_torch.models.gmm import DiagGMM, log_weighted
from audioanalysisdetector_tpu_torch.parallel.mesh import make_mesh_2d, process_count


def shard_components(gmm: DiagGMM, n_shards: int) -> DiagGMM:
    """Pad K to a multiple of ``n_shards`` with -inf-weight dummy components.

    Dummy components have weight 0 (log weight -inf) so they never
    contribute to the logsumexp; variances are 1 to keep densities finite."""
    k, d = gmm.means.shape
    k_pad = -(-k // n_shards) * n_shards
    if k_pad == k:
        return gmm
    pad = k_pad - k
    w, mu, var = gmm.weights, gmm.means, gmm.variances
    return DiagGMM(
        weights=torch.cat([w, w.new_zeros(pad)]),
        means=torch.cat([mu, mu.new_zeros((pad, d))]),
        variances=torch.cat([var, var.new_ones((pad, d))]),
    )


def _local_components(gmm: DiagGMM, index: int, n_shards: int) -> DiagGMM:
    per = gmm.means.shape[0] // n_shards
    sl = slice(index * per, (index + 1) * per)
    return DiagGMM(weights=gmm.weights[sl], means=gmm.means[sl], variances=gmm.variances[sl])


def _sharded_score_samples(x: torch.Tensor, gmm: DiagGMM, group) -> torch.Tensor:
    """Per-frame log-likelihood with components sharded over ``group``."""
    lw = log_weighted(x, gmm)  # (..., K_local); -inf for dummy components
    m = torch.amax(lw, dim=-1)
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
    total = torch.sum(torch.exp(lw - m[..., None]), dim=-1)
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    return m + torch.log(total)


def make_sharded_masked_llr(
    mesh,
    gmm1: DiagGMM,
    gmm2: DiagGMM,
    *,
    data_axis: str = "data",
    model_axis: str = "model",
):
    """``(x (B_local, T, D), mask (B_local, T)) -> llr (B_local,)`` on a 2-D
    mesh: ``x`` is this rank's rows (its ``data_axis`` shard, which the
    caller takes with ``shard_batch``), both GMMs' components shard over
    ``model_axis``. Matches ``models.gmm.masked_llr`` on those rows
    numerically."""
    group = mesh.get_group(model_axis)
    n_model, index = mesh[model_axis].size(), mesh.get_local_rank(model_axis)
    g1 = _local_components(shard_components(gmm1, n_model), index, n_model)
    g2 = _local_components(shard_components(gmm2, n_model), index, n_model)

    @torch.no_grad()
    def score(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        diff = _sharded_score_samples(x, g1, group) - _sharded_score_samples(x, g2, group)
        m = mask.to(diff.dtype)
        return torch.sum(diff * m, dim=-1) / torch.clamp(torch.sum(m, dim=-1), min=1.0)

    return score


def make_mesh_2d_for(n_devices: int | None = None, model: int = 2):
    """Convenience (data, model) mesh over the ranks."""
    n = process_count() if n_devices is None else n_devices
    if n % model:
        raise ValueError(f"{n} devices not divisible by model={model}")
    return make_mesh_2d(n // model, model)
