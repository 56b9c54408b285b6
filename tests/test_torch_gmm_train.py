"""The port's GMM training (k-means seeding, EM, MAP) vs the JAX package's, on the CPU.

The same numpy frames go to both packages: well-separated mixtures, so the
seeding and every EM iteration assign the same components and the fits
differ only by fp32 summation order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audioanalysisdetector_tpu.models import gmm as J
from audioanalysisdetector_tpu_torch.models import gmm as T

torch.set_num_threads(2)

# k-means centres (|x| up to ~12): Lloyd means of the same frames summed in
# other orders, absolute
CENTRE_TOL = 1e-5
# EM and MAP parameters, relative to each array's largest entry: fp32
# statistics of ~2000 frames summed in other orders, through up to 60 EM
# iterations (this data reads ~2e-5 at most)
PARAM_RTOL = 1e-4
# per-iteration mean log-likelihoods printed by the verbose path
LL_TOL = 1e-5
K, D = 4, 3


def _mixture(n: int = 2000, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    centres = rng.standard_normal((K, D)) * 5
    scales = rng.uniform(0.5, 1.5, (K, D))
    comp = rng.integers(0, K, n)
    return (centres[comp] + rng.standard_normal((n, D)) * scales[comp]).astype(np.float32)


def _assert_gmm_close(ours: T.DiagGMM, ref: J.DiagGMM, rtol: float = PARAM_RTOL):
    for k in ("weights", "means", "variances"):
        want = np.asarray(getattr(ref, k))
        got = getattr(ours, k).cpu().numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.abs(want).max(), err_msg=k)


@pytest.mark.parametrize("seed", [0, 3])
def test_kmeans_init_matches_jax(seed):
    x = _mixture(seed=seed)
    ours = T._kmeans_init(x, K, seed, device="cpu")
    np.testing.assert_allclose(ours, J._kmeans_init(x, K, seed), rtol=0, atol=CENTRE_TOL)
    # a tensor draws the same subsample and centres as an array
    np.testing.assert_array_equal(T._kmeans_init(torch.from_numpy(x), K, seed), ours)


def _verbose_lls(capsys) -> list[float]:
    return [float(line.split()[-1]) for line in capsys.readouterr().out.splitlines() if line.startswith("EM iter")]


@pytest.mark.parametrize("path", ["flat", "chunked", "tensor"])
@pytest.mark.parametrize("var_floor_rel", [0.0, 1e-3])
def test_fit_em_matches_jax(path, var_floor_rel, capsys):
    """Parameters, and the stopping iteration with every LL of the way."""
    x = _mixture(seed=1)
    kw = dict(max_iter=60, tol=1e-4, seed=2, var_floor_rel=var_floor_rel, verbose=True,
              flat_bytes=0 if path == "chunked" else 2 << 30, chunk=512)
    ref = J.fit_em(jnp.asarray(x) if path == "tensor" else x, K, **kw)
    ref_lls = _verbose_lls(capsys)
    ours = T.fit_em(torch.from_numpy(x) if path == "tensor" else x, K, device="cpu", **kw)
    lls = _verbose_lls(capsys)
    assert 2 < len(lls) < 60 and len(lls) == len(ref_lls)  # stopped early, at the same iteration
    np.testing.assert_allclose(lls, ref_lls, rtol=0, atol=LL_TOL)
    _assert_gmm_close(ours, ref)


@pytest.mark.parametrize("path", ["flat", "chunked"])
def test_windowed_stop_equals_verbose_stop(path, capsys):
    """The LLs fetched once a window stop at the model the per-iteration
    fetch stops at: the one after the first iteration with |ΔLL| < tol."""
    x = _mixture(seed=4)
    kw = dict(max_iter=60, tol=1e-4, seed=0, device="cpu", flat_bytes=0 if path == "chunked" else 2 << 30,
              chunk=512)
    loud = T.fit_em(x, K, verbose=True, **kw)
    n_iter = len(_verbose_lls(capsys))
    assert n_iter % 10 != 0 and n_iter < 60  # the stop falls inside a window
    quiet = T.fit_em(x, K, **kw)
    assert capsys.readouterr().out == ""
    for k in ("weights", "means", "variances"):
        torch.testing.assert_close(getattr(quiet, k), getattr(loud, k), rtol=0, atol=0)
    # the window's model is the stop's, not the window's last
    later = T.fit_em(x, K, verbose=True, **{**kw, "max_iter": n_iter + 1, "tol": 0.0})
    assert not torch.equal(later.means, quiet.means) or not torch.equal(later.variances, quiet.variances)


def test_em_variance_is_biased():
    """The initial variances (and the floor) are numpy's biased variance,
    for a tensor input as for an array (``torch.var`` is unbiased unless
    told otherwise): with 6 frames the two differ by 20%."""
    x = _mixture(6, seed=5)
    biased = x.var(axis=0)
    for inp in (x, torch.from_numpy(x)):
        g = T.fit_em(inp, 2, max_iter=0, reg_covar=0.0, device="cpu")
        np.testing.assert_allclose(g.variances.numpy(), np.broadcast_to(biased, (2, D)), rtol=1e-6)
    ref = J.fit_em(jnp.asarray(x), 2, max_iter=0, reg_covar=0.0)
    np.testing.assert_allclose(np.asarray(ref.variances), np.broadcast_to(biased, (2, D)), rtol=1e-6)


@pytest.fixture(scope="module")
def ubm():
    x = _mixture(seed=6)
    ref = J.fit_em(x, K, max_iter=20, seed=1)
    return x, ref, T.from_numpy(J.to_numpy(ref), device="cpu")


@pytest.mark.parametrize("mode", ["means", "full"])
@pytest.mark.parametrize("weights", ["none", "mask", "soft"])
@pytest.mark.parametrize("chunked", [False, True])
def test_map_adapt_matches_jax(ubm, mode, weights, chunked):
    x, jubm, tubm = ubm
    w = {"none": None, "mask": (np.arange(len(x)) % 3 == 0).astype(np.float32),
         "soft": np.random.default_rng(7).uniform(0, 1, len(x)).astype(np.float32)}[weights]
    full = mode == "full"
    kw = dict(relevance_factor=10.0, adapt_vars=full, adapt_weights=full)
    ref = J.map_adapt(jubm, jnp.asarray(x), frame_weights=None if w is None else jnp.asarray(w), **kw)
    adapt = (lambda *a, **k: T.map_adapt_chunked(*a, chunk=512, **k)) if chunked else T.map_adapt
    ours = adapt(tubm, torch.from_numpy(x), frame_weights=None if w is None else torch.from_numpy(w), **kw)
    _assert_gmm_close(ours, ref)
    if chunked:
        jref = J.map_adapt_chunked(jubm, jnp.asarray(x), chunk=512,
                                   frame_weights=None if w is None else jnp.asarray(w), **kw)
        _assert_gmm_close(ours, jref)
    if not full:  # means-only MAP keeps the UBM's variances and weights
        assert torch.equal(ours.variances, tubm.variances) and torch.equal(ours.weights, tubm.weights)


def test_masked_map_equals_map_of_the_subset(ubm):
    """A 0/1 frame mask adapts as slicing the subset out does."""
    x, _, tubm = ubm
    keep = np.arange(len(x)) % 4 == 1
    kw = dict(adapt_vars=True, adapt_weights=True)
    masked = T.map_adapt(tubm, torch.from_numpy(x), frame_weights=torch.from_numpy(keep.astype(np.float32)), **kw)
    subset = T.map_adapt(tubm, torch.from_numpy(x[keep]), **kw)
    for k in ("weights", "means", "variances"):
        torch.testing.assert_close(getattr(masked, k), getattr(subset, k), rtol=1e-5, atol=1e-5)
