"""The port's component- and frame-sharded GMM on 2 gloo ranks vs the JAX package on 2 devices, on the CPU.

``make_sharded_masked_llr`` on the (1 data x 2 model) and (2 x 1) meshes
against JAX's on the same layouts of the conftest's virtual CPU devices and
against the unsharded ``masked_llr``; the frame-sharded EM and MAP against
the single fit and against JAX's fit of a frame-sharded array.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from audioanalysisdetector_tpu.models import gmm as J
from audioanalysisdetector_tpu.parallel.mesh import make_mesh as j_make_mesh
from audioanalysisdetector_tpu.parallel.mesh import make_mesh_2d as j_make_mesh_2d
from audioanalysisdetector_tpu.parallel.sharded_gmm import make_sharded_masked_llr as j_make_sharded_masked_llr
from audioanalysisdetector_tpu.parallel.sharded_gmm import shard_components as j_shard_components
from audioanalysisdetector_tpu_torch.models import gmm as T
from audioanalysisdetector_tpu_torch.parallel.sharded_gmm import shard_components
from tests import _torch_ranks as R

torch.set_num_threads(2)

# per-row llr of 6-component GMMs over 12 frames: the component logsumexp
# split in two by a max and a sum over the ranks, fp32
LLR_RTOL = 1e-5
# EM over 40 iterations (tol 0) and one MAP, sharded against single, at
# the JAX package's bounds (tests/test_sharded_gmm.py:74-89): fp32
# statistics of 4096 frames summed as two halves or whole
EM_WEIGHT_ATOL = 1e-5
EM_MEAN_RTOL = EM_MEAN_ATOL = 1e-4
EM_LL_RTOL = 1e-6
EM_KW = dict(n_components=8, max_iter=40, tol=0.0, seed=1)


def _gmm(rng, k, d=7) -> dict:
    return {
        "weights": rng.dirichlet(np.ones(k)).astype(np.float32),
        "means": rng.standard_normal((k, d)).astype(np.float32),
        "variances": (rng.random((k, d)) + 0.5).astype(np.float32),
    }


def _jgmm(d: dict) -> J.DiagGMM:
    return J.DiagGMM(**{k: jnp.asarray(v) for k, v in d.items()})


def _inputs():
    rng = np.random.default_rng(0)
    g1, g2 = _gmm(rng, 6), _gmm(rng, 6)
    x = rng.standard_normal((8, 12, 7)).astype(np.float32)
    x[3, 9:] = 0.0
    mask = x.sum(axis=-1) != 0
    frames = (rng.standard_normal((4096, 8)) * [1, 2, 1, 0.5, 1, 1, 2, 1]
              + rng.integers(-2, 3, (1, 8))).astype(np.float32)
    return g1, g2, x, mask, frames


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return R.run_ranks(R.sharded_gmm, 2, tmp_path_factory.mktemp("gmm"), *_inputs(), EM_KW)


def test_component_padding_is_neutral():
    rng = np.random.default_rng(1)
    g = _gmm(rng, 5)
    padded = shard_components(T.from_numpy(g, device="cpu"), 4)  # 5 -> 8 components
    jpadded = j_shard_components(_jgmm(g), 4)
    for k in ("weights", "means", "variances"):
        np.testing.assert_array_equal(getattr(padded, k).numpy(), np.asarray(getattr(jpadded, k)))
    x = rng.standard_normal((10, 7)).astype(np.float32)
    np.testing.assert_allclose(T.score_samples(torch.from_numpy(x), padded).numpy(),
                               T.score_samples(torch.from_numpy(x), T.from_numpy(g, device="cpu")).numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("layout", [(1, 2), (2, 1)])
def test_sharded_llr_matches_jax_and_unsharded(ranks, layout):
    """Each rank scores its data shard with its half (or all) of the
    components; the rows, in rank order, are JAX's sharded llr and the
    port's own ``masked_llr``."""
    g1, g2, x, mask, _ = _inputs()
    dp, mp = layout
    ours = np.concatenate([r[layout] for r in ranks[::mp]])  # one rank per data shard
    for r in ranks:
        shard = r[layout]
        assert shard.shape == (8 // dp,)
    jmesh = j_make_mesh_2d(dp, mp)
    ref = np.asarray(j_make_sharded_masked_llr(jmesh, _jgmm(g1), _jgmm(g2))(jnp.asarray(x), jnp.asarray(mask)))
    plain = T.masked_llr(torch.from_numpy(x), torch.from_numpy(mask), T.from_numpy(g1, device="cpu"),
                         T.from_numpy(g2, device="cpu")).numpy()
    scale = np.abs(plain).max()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=LLR_RTOL * scale)
    np.testing.assert_allclose(ours, plain, rtol=0, atol=LLR_RTOL * scale)
    if mp == 2:  # both model ranks hold the same rows' scores
        np.testing.assert_array_equal(ranks[0][layout], ranks[1][layout])


def _assert_em_close(got: dict, want, frames: np.ndarray):
    np.testing.assert_allclose(got["weights"], np.asarray(want.weights), atol=EM_WEIGHT_ATOL)
    np.testing.assert_allclose(got["means"], np.asarray(want.means), rtol=EM_MEAN_RTOL, atol=EM_MEAN_ATOL)
    xj = jnp.asarray(frames)
    np.testing.assert_allclose(float(J.score(xj, _jgmm(got))), float(J.score(xj, want)), rtol=EM_LL_RTOL)


def test_frame_sharded_em_and_map_match_single_and_jax(ranks):
    """``fit_em(group=...)`` on two halves of the frames (flat and chunked
    E-steps) against the port's single fit and JAX's fit of a frame-sharded
    array on 2 devices; ``map_adapt`` / ``map_adapt_chunked`` likewise."""
    *_, frames = _inputs()
    single = T.fit_em(frames, device="cpu", **EM_KW)
    as_j = J.DiagGMM(*(jnp.asarray(v.numpy()) for v in (single.weights, single.means, single.variances)))
    xd = jax.device_put(frames, NamedSharding(j_make_mesh(2), P("data")))
    jsharded = J.fit_em(xd, **EM_KW)
    for r in ranks:
        for key in ("em", "em_chunked"):
            _assert_em_close(r[key], as_j, frames)
            _assert_em_close(r[key], jsharded, frames)
    for k in ("weights", "means", "variances"):  # every rank holds the same model
        np.testing.assert_array_equal(ranks[0]["em"][k], ranks[1]["em"][k])

    ubm = T.from_numpy(ranks[0]["em"], device="cpu")
    w = torch.ones(len(frames))
    want = T.map_adapt(ubm, torch.from_numpy(frames), frame_weights=w)
    jwant = J.map_adapt(_jgmm(ranks[0]["em"]), xd, frame_weights=jax.device_put(
        np.ones(len(frames), np.float32), NamedSharding(j_make_mesh(2), P("data"))))
    for r in ranks:
        for key in ("map", "map_chunked"):
            for ref in (want.means.numpy(), np.asarray(jwant.means)):
                np.testing.assert_allclose(r[key]["means"], ref, rtol=EM_MEAN_RTOL, atol=EM_MEAN_ATOL)
