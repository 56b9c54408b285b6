"""Diagonal-covariance GMM-UBM with MAP adaptation (PyTorch).

Counterpart of the JAX package's ``models/gmm.py`` (the reference's
sklearn GMM subsystem, reference/ASV_dl_func.py:1132-1203): per-component
log-densities, per-frame log-likelihoods, the mean-frame log-likelihood
ratio and its padding-masked form; EM fitting (flat and chunked E-steps,
k-means++ seeding with Lloyd iterations, windowed stopping) and MAP
adaptation (flat and chunked). Densities use the JAX package's quadratic
expansion ``(x - mu)^2 / var = x^2 (1/var) - 2 x (mu/var) + mu^2/var``
(two GEMMs), so both packages cancel the same terms in fp32 and no
(N, K, D) tensor is ever formed. The JAX package computes all of it with
XLA (no Pallas kernel), so the port runs plain PyTorch: cuBLAS SGEMM and
elementwise passes on the card.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

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


# ---------------------------------------------------------------- EM fitting


def _estep_stats(x_chunk: torch.Tensor, w_chunk: torch.Tensor, gmm: DiagGMM):
    """Weighted sufficient statistics of one chunk. w_chunk masks padding."""
    logr = log_weighted(x_chunk, gmm)
    log_norm = torch.logsumexp(logr, dim=-1, keepdim=True)
    resp = torch.exp(logr - log_norm) * w_chunk[:, None]
    nk = torch.sum(resp, dim=0)  # (K,)
    fk = resp.T @ x_chunk  # (K, D)
    sk = resp.T @ (x_chunk * x_chunk)  # (K, D)
    ll = torch.sum(log_norm[:, 0] * w_chunk)
    return nk, fk, sk, ll


def _pad_to_chunks(x: np.ndarray, chunk: int) -> tuple[np.ndarray, np.ndarray]:
    n = x.shape[0]
    n_chunks = -(-n // chunk)
    pad = n_chunks * chunk - n
    xp = np.pad(x, ((0, pad), (0, 0)))
    w = np.concatenate([np.ones(n), np.zeros(pad)]).astype(x.dtype)
    return xp.reshape(n_chunks, chunk, -1), w.reshape(n_chunks, chunk)


def _pad_on_device(x: torch.Tensor, w: torch.Tensor, chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``_pad_to_chunks`` of a tensor and its frame weights, where they lie."""
    n_chunks = -(-x.shape[0] // chunk)
    pad = n_chunks * chunk - x.shape[0]
    xc = torch.nn.functional.pad(x, (0, 0, 0, pad)).reshape(n_chunks, chunk, -1)
    return xc, torch.nn.functional.pad(w, (0, pad)).reshape(n_chunks, chunk)


def _m_step(nk, fk, sk, n_total, reg_covar: float) -> DiagGMM:
    nk_safe = nk + 10.0 * torch.finfo(fk.dtype).eps
    means = fk / nk_safe[:, None]
    variances = sk / nk_safe[:, None] - means * means + reg_covar
    return DiagGMM(weights=nk / n_total, means=means, variances=variances)


def _em_step_flat(x: torch.Tensor, gmm: DiagGMM, reg_covar: float = 1e-6):
    """One EM iteration with the (N, K) responsibilities materialized (920
    MB for the reference's 1.8M-frame, 128-component UBM); ``fit_em`` takes
    it whenever that fits ``flat_bytes``. Returns (model, mean LL)."""
    lr = log_weighted(x, gmm)
    ln = torch.logsumexp(lr, dim=-1, keepdim=True)
    resp = torch.exp(lr - ln)
    nk = torch.sum(resp, dim=0)
    fk = resp.T @ x
    sk = resp.T @ (x * x)
    n_total = x.shape[0]
    return _m_step(nk, fk, sk, n_total, reg_covar), torch.sum(ln) / n_total


def _em_step(xc: torch.Tensor, wc: torch.Tensor, gmm: DiagGMM, reg_covar: float = 1e-6):
    """One EM iteration over (n_chunks, chunk, D) frames: the statistics
    accumulate chunk by chunk (the JAX package's ``lax.scan``), so only
    (chunk, K) is ever materialized."""
    k, d = gmm.means.shape
    nk = torch.zeros(k, dtype=xc.dtype, device=xc.device)
    fk = torch.zeros((k, d), dtype=xc.dtype, device=xc.device)
    sk = torch.zeros((k, d), dtype=xc.dtype, device=xc.device)
    ll = torch.zeros((), dtype=xc.dtype, device=xc.device)
    for x_c, w_c in zip(xc, wc):
        dnk, dfk, dsk, dll = _estep_stats(x_c, w_c, gmm)
        nk, fk, sk, ll = nk + dnk, fk + dfk, sk + dsk, ll + dll
    n_total = torch.sum(wc)
    return _m_step(nk, fk, sk, n_total, reg_covar), ll / n_total


def _lloyd(sub: torch.Tensor, centers: torch.Tensor, iters: int = 10) -> torch.Tensor:
    """Lloyd iterations where ``sub`` lies: distances and segment means as
    GEMMs (argmin takes the first index on ties, as in the JAX package)."""
    c = centers
    for _ in range(iters):
        d2 = torch.sum(sub * sub, dim=1, keepdim=True) - 2.0 * (sub @ c.T) + torch.sum(c * c, dim=1)
        onehot = torch.nn.functional.one_hot(torch.argmin(d2, dim=1), c.shape[0]).to(sub.dtype)
        counts = torch.sum(onehot, dim=0)  # (K,)
        sums = onehot.T @ sub  # (K, D)
        c = torch.where(counts[:, None] > 0, sums / torch.clamp(counts, min=1.0)[:, None], c)
    return c


def _kmeans_init(x, k: int, seed: int, iters: int = 10, *, device: str | torch.device = "cuda") -> np.ndarray:
    """k-means++ seeding (host, incremental) + Lloyd on ``device``.

    ``x`` is a numpy array or a tensor (then its own device is used): only
    the <=100k-row subsample crosses to the host. numpy's generator is drawn
    in the JAX package's order (subsample ``choice``, first centre
    ``integers``, then one ``choice(p=...)`` per centre with float32
    distances), so both packages seed the same centres."""
    rng = np.random.default_rng(seed)
    idx = rng.choice(x.shape[0], min(x.shape[0], 100_000), replace=False)
    if isinstance(x, torch.Tensor):
        device = x.device
        sub = x[torch.from_numpy(idx).to(device)].cpu().numpy()
    else:
        sub = x[idx]
    seed_pool = sub[: min(len(sub), 20_000)]
    centers = [seed_pool[rng.integers(len(seed_pool))]]
    d2 = np.full(len(seed_pool), np.inf, dtype=np.float32)
    for _ in range(1, k):
        d2 = np.minimum(d2, ((seed_pool - centers[-1]) ** 2).sum(-1))
        probs = d2 / d2.sum()
        centers.append(seed_pool[rng.choice(len(seed_pool), p=probs)])
    out = _lloyd(torch.from_numpy(sub).to(device), torch.from_numpy(np.stack(centers)).to(device), iters=iters)
    return out.cpu().numpy()


def _floor_variances(gmm: DiagGMM, floor: torch.Tensor) -> DiagGMM:
    return replace(gmm, variances=torch.maximum(gmm.variances, floor))


@torch.no_grad()
def fit_em(
    x,
    n_components: int = 128,
    *,
    max_iter: int = 100,
    tol: float = 1e-3,
    reg_covar: float = 1e-6,
    var_floor_rel: float = 0.0,
    seed: int = 42,
    chunk: int = 65536,
    flat_bytes: int = 2 << 30,
    verbose: bool = False,
    device: str | torch.device = "cuda",
) -> DiagGMM:
    """Fit a diagonal GMM by EM (sklearn-equivalent semantics).

    ``x`` (N, D) is a numpy array, uploaded once to ``device``, or a
    tensor, which stays where it lies (then nothing but the k-means
    subsample and the LLs crosses to the host). ``tol`` is on the change of
    mean per-frame log-likelihood, like sklearn's ``lower_bound_`` test.

    ``var_floor_rel`` > 0 floors each component's per-dim variance at
    ``var_floor_rel * Var(x_dim)`` (biased variance) after every M-step:
    sklearn's additive ``reg_covar`` does not stop a component collapsing
    onto near-duplicate frames. 0.0 keeps exact sklearn semantics; the
    GMM-UBM system passes 1e-3.

    When the (N, K) responsibility matrix fits ``flat_bytes``
    (``N * n_components * 4``) the iterations run flat; larger fits take
    the chunked accumulator, which never materializes it. The rule is the
    JAX package's, so both packages sum in the same order.

    Convergence is checked in windows of 10 iterations: the LLs stay on the
    device and are fetched once a window, and the model returned is the one
    AFTER the first iteration whose |ΔLL| < tol. ``verbose`` fetches and
    prints every iteration's LL instead, with the same stop.
    """
    on_device = isinstance(x, torch.Tensor)
    if on_device:
        x = x.to(torch.float32)
        var_host = torch.var(x, dim=0, correction=0).cpu().numpy()
        device = x.device
    else:
        x = np.asarray(x, dtype=np.float32)
        var_host = x.var(axis=0)
    centers = _kmeans_init(x, n_components, seed, device=device)
    var0 = np.full((n_components, x.shape[1]), var_host + reg_covar, dtype=np.float32)
    gmm = DiagGMM(
        weights=torch.full((n_components,), 1.0 / n_components, dtype=torch.float32, device=device),
        means=torch.from_numpy(np.asarray(centers, np.float32)).to(device),
        variances=torch.from_numpy(var0).to(device),
    )
    floor = (
        torch.from_numpy(np.asarray(var_floor_rel * var_host + reg_covar, np.float32)).to(device)
        if var_floor_rel > 0
        else None
    )
    if x.shape[0] * n_components * 4 <= flat_bytes:
        xd = x if on_device else torch.from_numpy(x).to(device)
        step = lambda g: _em_step_flat(xd, g, reg_covar=reg_covar)  # noqa: E731
    else:
        if on_device:
            xc, wc = _pad_on_device(x, torch.ones(x.shape[0], dtype=x.dtype, device=device), chunk)
        else:
            xc_np, wc_np = _pad_to_chunks(x, chunk)
            xc, wc = torch.from_numpy(xc_np).to(device), torch.from_numpy(wc_np).to(device)
        step = lambda g: _em_step(xc, wc, g, reg_covar=reg_covar)  # noqa: E731
    if floor is not None:
        base_step = step

        def step(g, _base=base_step, _floor=floor):
            g2, ll = _base(g)
            return _floor_variances(g2, _floor), ll

    if verbose:
        prev_ll = -np.inf
        for it in range(max_iter):
            gmm, ll = step(gmm)
            ll = float(ll)
            print(f"EM iter {it}: mean LL {ll:.6f}")
            if tol > 0 and abs(ll - prev_ll) < tol:
                break
            prev_ll = ll
        return gmm
    sync_every = 10
    prev_ll = -np.inf
    window_lls: list = []
    window_states: list = []
    for it in range(max_iter):
        gmm, ll = step(gmm)
        window_lls.append(ll)
        window_states.append(gmm)
        if len(window_lls) == sync_every or it == max_iter - 1:
            if tol > 0:
                vals = torch.stack(window_lls).cpu().numpy()
                deltas = np.abs(np.diff(np.concatenate([[prev_ll], vals])))
                hits = np.nonzero(deltas < tol)[0]
                if hits.size:
                    return window_states[int(hits[0])]
                prev_ll = float(vals[-1])
            window_lls.clear()
            window_states.clear()
    return gmm


@torch.no_grad()
def map_adapt(
    ubm: DiagGMM,
    x: torch.Tensor,
    *,
    relevance_factor: float = 10.0,
    var_floor: float = 1e-6,
    frame_weights: torch.Tensor | None = None,
    adapt_vars: bool = True,
    adapt_weights: bool = True,
) -> DiagGMM:
    """MAP adaptation with the reference's update equations
    (reference/ASV_dl_func.py:1172-1197). Every reference iteration
    recomputes the responsibilities from the UBM, so one evaluation is its
    fixed point.

    ``frame_weights`` (N,) weights each frame's statistics: a 0/1 mask
    adapts to a subset of a shared frame buffer without a second upload.
    ``adapt_vars`` / ``adapt_weights`` default to the reference's full
    update; ``train_gmm_system`` defaults to means only (Reynolds et al.
    2000), which the JAX package measured to keep the LLR stable."""
    resp = predict_proba(x, ubm)  # (N, K)
    if frame_weights is not None:
        resp = resp * frame_weights[:, None]
    nk = torch.sum(resp, dim=0)
    fk = resp.T @ x
    sk = resp.T @ (x * x) if adapt_vars else None
    return _map_from_stats(
        ubm, nk, fk, sk, relevance_factor=relevance_factor,
        var_floor=var_floor, adapt_vars=adapt_vars, adapt_weights=adapt_weights,
    )


def _map_from_stats(
    ubm: DiagGMM,
    nk: torch.Tensor,
    fk: torch.Tensor,
    sk: torch.Tensor | None,
    *,
    relevance_factor: float,
    var_floor: float,
    adapt_vars: bool,
    adapt_weights: bool,
) -> DiagGMM:
    """The closed-form MAP update from sufficient statistics, shared by
    ``map_adapt`` and ``map_adapt_chunked``."""
    nk = nk + 1e-6
    alpha = nk / (nk + relevance_factor)
    a = alpha[:, None]
    new_means = a * (fk / nk[:, None]) + (1.0 - a) * ubm.means
    if adapt_vars:
        new_vars = a * (sk / nk[:, None] - new_means**2) + (1.0 - a) * ubm.variances
        new_vars = torch.clamp(new_vars, min=var_floor)
    else:
        new_vars = ubm.variances
    if adapt_weights:
        new_weights = alpha * (nk / torch.sum(nk)) + (1.0 - alpha) * ubm.weights
        new_weights = new_weights / torch.sum(new_weights)
    else:
        new_weights = ubm.weights
    return DiagGMM(weights=new_weights, means=new_means, variances=new_vars)


@torch.no_grad()
def map_adapt_chunked(
    ubm: DiagGMM,
    x: torch.Tensor,
    *,
    chunk: int = 65536,
    relevance_factor: float = 10.0,
    var_floor: float = 1e-6,
    frame_weights: torch.Tensor | None = None,
    adapt_vars: bool = True,
    adapt_weights: bool = True,
) -> DiagGMM:
    """``map_adapt`` for frame buffers whose (N, K) responsibility matrix
    would not fit: the statistics accumulate over fixed-size chunks (EM's
    chunked accumulator), so only (chunk, K) is materialized. Equal to the
    flat path up to summation order."""
    w = frame_weights.to(x.dtype) if frame_weights is not None else torch.ones(x.shape[0], dtype=x.dtype, device=x.device)
    xc, wc = _pad_on_device(x, w, chunk)
    k, d = ubm.means.shape
    nk = torch.zeros(k, dtype=x.dtype, device=x.device)
    fk = torch.zeros((k, d), dtype=x.dtype, device=x.device)
    sk = torch.zeros((k, d), dtype=x.dtype, device=x.device)
    for x_c, w_c in zip(xc, wc):
        cnk, cfk, csk, _ll = _estep_stats(x_c, w_c, ubm)
        nk, fk, sk = nk + cnk, fk + cfk, sk + csk
    return _map_from_stats(
        ubm, nk, fk, sk if adapt_vars else None, relevance_factor=relevance_factor,
        var_floor=var_floor, adapt_vars=adapt_vars, adapt_weights=adapt_weights,
    )


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
