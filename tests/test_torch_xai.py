"""The port's XAI subsystem vs the JAX package's, on the CPU.

Saliency, integrated gradients, occlusion and Grad-CAM of the same
``AntiSpoofingResNet`` weights on the same ``(2, 16, 12)`` maps; the
bilinear resize against ``jax.image.resize``; ``bilstm_heatmaps`` of one
``BiLSTMClassifier``; the LIME perturbations fed JAX's draws (the choice of
rows and slices bitwise), the kernel weights, the numpy surrogate against
sklearn's ``LinearRegression``;
``gmm_shap`` and ``compare_gmm_bilstm`` with the same coalitions; the
interval extraction; and the plots and the HTML page with and without
matplotlib.
"""

import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.linear_model import LinearRegression

from audioanalysisdetector_tpu.models.bilstm_classifier import BiLSTMClassifier as JBiLSTMClassifier
from audioanalysisdetector_tpu.models.gmm import DiagGMM as JDiagGMM
from audioanalysisdetector_tpu.models.gmm import masked_llr as j_masked_llr
from audioanalysisdetector_tpu.models.resnet import AntiSpoofingResNet as JAntiSpoofingResNet
from audioanalysisdetector_tpu.xai import attribution as jattr
from audioanalysisdetector_tpu.xai import compare as jcompare
from audioanalysisdetector_tpu.xai import lime as jlime
from audioanalysisdetector_tpu.xai import shap_gmm as jshap
from audioanalysisdetector_tpu_torch import xai
from audioanalysisdetector_tpu_torch.convert import (
    flax_to_torch_bilstm_classifier,
    flax_to_torch_resnet,
    random_diag_gmm,
    random_flax_bilstm_classifier,
    random_flax_resnet,
)
from audioanalysisdetector_tpu_torch.models.bilstm_classifier import BiLSTMClassifier
from audioanalysisdetector_tpu_torch.models.gmm import from_numpy, masked_llr
from audioanalysisdetector_tpu_torch.models.resnet import AntiSpoofingResNet
from audioanalysisdetector_tpu_torch.xai.attribution import resize_bilinear
from audioanalysisdetector_tpu_torch.xai.lime import features_mean_from_scores, segments_from_scores

torch.set_num_threads(2)

# gradients of fp32 logits through 13 conv + BN layers (oneDNN against
# XLA), relative to each map's largest entry
GRAD_RTOL = 1e-4
# occlusion: score drops are differences of logits of size ~10, each
# rounded to ~1e-6 of it; relative to the largest drop
OCC_RTOL = 1e-4
# bilinear weights of the same grid: one rounding apart
RESIZE_TOL = 1e-6
# the surrogate: float64 least squares against sklearn's (scipy's lstsq),
# both minimum-norm
SURROGATE_TOL = 1e-8
# kernel SHAP: the same coalitions, scores of fp32 GMM log-likelihoods
# summed in other orders (~1e-7 of a probability), through a WLS solve
SHAP_TOL = 1e-5
B, H, W = 2, 16, 12


@pytest.fixture(scope="module")
def resnet():
    v = random_flax_resnet(11)
    m = AntiSpoofingResNet()
    m.load_state_dict(flax_to_torch_resnet(v))
    x = np.random.default_rng(12).standard_normal((B, H, W)).astype(np.float32)
    return m.eval(), JAntiSpoofingResNet(), v, x


def _close(got: torch.Tensor, ref, rtol: float) -> None:
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=rtol, atol=rtol * np.abs(ref).max())


def test_saliency_matches_jax(resnet):
    m, jm, v, x = resnet
    _close(xai.saliency(m, torch.from_numpy(x)), jattr.saliency(jm.apply, v, jnp.asarray(x)), GRAD_RTOL)


@pytest.mark.parametrize("target", [0, 1])
def test_integrated_gradients_matches_jax(resnet, target):
    m, jm, v, x = resnet
    got = xai.integrated_gradients(m, torch.from_numpy(x), target=target, steps=4)
    _close(got, jattr.integrated_gradients(jm.apply, v, jnp.asarray(x), target=target, steps=4), GRAD_RTOL)


@pytest.mark.parametrize("window", [(3, 2), (1, 5)])
def test_occlusion_matches_jax(resnet, window):
    """(16 - wt + 1) x (12 - wf + 1) positions in chunks of 64 windows."""
    m, jm, v, x = resnet
    got = xai.occlusion(m, torch.from_numpy(x), window=window)
    _close(got, jattr.occlusion(jm.apply, v, jnp.asarray(x), window=window), OCC_RTOL)


@pytest.mark.parametrize("output_size", [None, (H, W)])
def test_grad_cam_matches_jax(resnet, output_size):
    m, jm, v, x = resnet
    got = xai.grad_cam(m, torch.from_numpy(x), output_size=output_size)
    ref = jattr.grad_cam(jm, v, jnp.asarray(x), output_size=output_size)
    assert got.shape == ref.shape == ((B, 6, 4) if output_size is None else (B, H, W))
    _close(got, ref, GRAD_RTOL)
    assert m.training is False


@pytest.mark.parametrize("src,dst", [((6, 4), (16, 12)), ((22, 21), (64, 63)), ((5, 5), (5, 9))])
def test_resize_bilinear_matches_jax_upsampling(src, dst):
    cam = np.random.default_rng(13).random((2, *src)).astype(np.float32)
    got = resize_bilinear(torch.from_numpy(cam), dst)
    ref = jax.image.resize(jnp.asarray(cam), (2, *dst), method="bilinear")
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RESIZE_TOL, atol=RESIZE_TOL)


def test_bilstm_heatmaps_match_jax():
    """IG (8 steps) and the (5, 1) occlusion of the fused system's BiLSTM,
    and their reductions; the LSTMs run in training mode for the gradient
    and return to eval mode after."""
    v = random_flax_bilstm_classifier(14, hidden=8, input_dim=5)
    m = BiLSTMClassifier(hidden=8, input_dim=5)
    m.load_state_dict(flax_to_torch_bilstm_classifier(v))
    m.eval()
    x = np.random.default_rng(15).standard_normal((1, 12, 5)).astype(np.float32)
    got = xai.bilstm_heatmaps(m, torch.from_numpy(x), steps=8)
    ref = jattr.bilstm_heatmaps(JBiLSTMClassifier(hidden=8).apply, v, jnp.asarray(x), steps=8)
    for k in ("ig", "occlusion", "feature_importance", "time_importance"):
        _close(got[k], ref[k], GRAD_RTOL)
    assert not any(mod.training for mod in m.modules())


def _same_perturbation(p: torch.Tensor, jp, x: np.ndarray) -> None:
    """The rows / slices left alone are JAX's bit for bit; the replaced
    values are means that each package sums in fp32 in its own order (XLA's
    vectorized reduction cannot be replayed), so within a few ulps of the
    map's largest entry (4.5e-8 read on entries up to ~3)."""
    p, jp = p.numpy(), np.asarray(jp)
    same = np.broadcast_to(x, p.shape) == jp
    np.testing.assert_array_equal(p[same], jp[same])
    np.testing.assert_allclose(p, jp, rtol=0, atol=4 * np.finfo(np.float32).eps * np.abs(x).max())


def _draws(n: int, width: int, seed: int) -> tuple[jax.Array, np.ndarray]:
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    return keys, np.stack([np.asarray(jax.random.uniform(k, (width,))) for k in keys])


@pytest.mark.parametrize("n_changed", [0, 4])
def test_lime_perturbations_match_jax_fed_its_draws(n_changed):
    """Each perturbation, given JAX's uniform draws, makes JAX's choice of
    rows / slices (masks bit for bit) and JAX's perturbed map."""
    x = np.random.default_rng(16).standard_normal((19, 63)).astype(np.float32)
    keys, u = _draws(5, 19, 1)
    p, mask = features_mean_from_scores(torch.from_numpy(x), torch.from_numpy(u), n_changed=n_changed)
    jp, jmask = jax.vmap(lambda k: jlime.perturb_random_features_mean(jnp.asarray(x), k, n_changed=n_changed))(keys)
    _same_perturbation(p, jp, x)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    keys, u = _draws(5, 9, 2)
    p, mask = segments_from_scores(torch.from_numpy(x), torch.from_numpy(u), num_slices=9, n_changed=n_changed)
    jp, jmask = jax.vmap(lambda k: jlime.perturb_segments(jnp.asarray(x), k, num_slices=9, n_changed=n_changed))(keys)
    _same_perturbation(p, jp, x)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    # one draw row per instance (lime_dataset)
    xs = np.random.default_rng(17).standard_normal((5, 19, 63)).astype(np.float32)
    p, _ = segments_from_scores(torch.from_numpy(xs), torch.from_numpy(u), num_slices=9, n_changed=n_changed)
    jp, _ = jax.vmap(lambda xi, k: jlime.perturb_segments(xi, k, num_slices=9, n_changed=n_changed))(jnp.asarray(xs), keys)
    _same_perturbation(p, jp, xs)


def test_perturbations_draw_from_the_generator():
    x = torch.from_numpy(np.random.default_rng(18).standard_normal((19, 63)).astype(np.float32))
    a = xai.perturb_random_features_mean(x, torch.Generator().manual_seed(3), n_changed=4)
    b = xai.perturb_random_features_mean(x, torch.Generator().manual_seed(3), n_changed=4)
    torch.testing.assert_close(a, b)
    assert int((a[1] == 0).sum()) == 4
    p, mask = xai.perturb_segments(x, torch.Generator().manual_seed(4), num_slices=9, n_changed=3)
    assert p.shape == x.shape and int((mask == 0).sum()) == 3
    np.testing.assert_array_equal(xai.signal_segmentation(63, 9), jlime.signal_segmentation(63, 9))


def test_kernel_weights_match_jax():
    masks = (np.random.default_rng(19).random((30, 19)) > 0.3).astype(np.float32)
    np.testing.assert_array_equal(xai.kernel_weights(masks), jlime.kernel_weights(masks))


@pytest.mark.parametrize("constant_rows", [False, True])
def test_surrogate_matches_sklearn(constant_rows):
    """The weighted least squares with an intercept, as sklearn's
    ``LinearRegression`` solves it, also when every mask has the same
    number of ones (columns dependent on the intercept: minimum norm)."""
    rng = np.random.default_rng(20)
    if constant_rows:
        masks = np.ones((40, 12))
        for r in masks:
            r[rng.choice(12, 4, replace=False)] = 0.0
    else:
        masks = (rng.random((40, 12)) > 0.4).astype(np.float64)
    scores = rng.random(40)
    weights = xai.kernel_weights(masks)
    ours = xai.fit_surrogate(masks, scores, weights)
    ref = LinearRegression().fit(masks, scores, sample_weight=weights)
    np.testing.assert_allclose(ours.coef_, ref.coef_, rtol=SURROGATE_TOL, atol=SURROGATE_TOL)
    np.testing.assert_allclose(ours.intercept_, ref.intercept_, rtol=SURROGATE_TOL, atol=SURROGATE_TOL)
    np.testing.assert_allclose(ours.predict(masks), ref.predict(masks), rtol=SURROGATE_TOL, atol=SURROGATE_TOL)


def _toy_scorer():
    """A scorer that reads coefficient row 3 alone: (B, 19, 63) -> (B,)."""
    w = torch.zeros(19, 63)
    w[3] = 0.3
    return lambda batch: torch.sigmoid((batch * w).sum(dim=(-1, -2)))


def test_lime_single_instance_and_dataset(tmp_path):
    rng = np.random.default_rng(21)
    inst = rng.standard_normal((19, 63)).astype(np.float32)
    inst[3] += 1.0
    out = xai.lime_single_instance(_toy_scorer(), inst, n_perturbations=64, n_changed=4, seed=1)
    assert 3 in out["top_components"] and out["masks"].shape == (64, 19)
    assert out["score"] == pytest.approx(float(_toy_scorer()(torch.from_numpy(inst)[None])[0]))
    again = xai.lime_single_instance(_toy_scorer(), torch.from_numpy(inst), n_perturbations=64, n_changed=4, seed=1)
    np.testing.assert_array_equal(again["coefficients"], out["coefficients"])
    timed = xai.lime_single_instance(_toy_scorer(), inst, mode="time", n_perturbations=16, seed=2)
    assert timed["masks"].shape == (16, 9)
    path = tmp_path / "lime_regression_feature_slice_9.pkl"
    res = xai.lime_dataset(_toy_scorer(), rng.standard_normal((8, 19, 63)).astype(np.float32), save_path=str(path))
    assert res["masks"].shape == (8, 19)
    with open(path, "rb") as f:
        loaded = pickle.load(f)
    np.testing.assert_array_equal(loaded.predict(res["masks"]), res["surrogate"].predict(res["masks"]))


def _gmms(k: int, d: int):
    a, b = random_diag_gmm(22, k, d), random_diag_gmm(23, k, d)
    port = (from_numpy(a, device="cpu"), from_numpy(b, device="cpu"))
    jax_ = tuple(JDiagGMM(*(jnp.asarray(g[n]) for n in ("weights", "means", "variances"))) for g in (a, b))

    def score(batch):
        return torch.sigmoid(masked_llr(batch, torch.ones(batch.shape[:-1], dtype=torch.bool), *port))

    def jscore(batch):
        return jax.nn.sigmoid(j_masked_llr(batch, jnp.ones(batch.shape[:-1], bool), *jax_))

    return score, jscore


@pytest.mark.parametrize("T,coalitions", [(20, 64), (63, 32)])
def test_gmm_shap_matches_jax(T, coalitions):
    """Exact mode (3 windows: all 8 coalitions) and sampled mode (12
    windows, 32 coalitions drawn by numpy as in JAX)."""
    score, jscore = _gmms(4, 5)
    x = np.random.default_rng(24).standard_normal((T, 5)).astype(np.float32)
    got = xai.gmm_shap(score, x, n_coalitions=coalitions, seed=3)
    ref = jshap.gmm_shap(jscore, x, n_coalitions=coalitions, seed=3)
    np.testing.assert_allclose(got, ref, rtol=SHAP_TOL, atol=SHAP_TOL * np.abs(ref).max())
    np.testing.assert_array_equal(xai.time_windows(T), jshap.time_windows(T))


def test_compare_gmm_bilstm_matches_jax():
    score, jscore = _gmms(4, 5)
    v = random_flax_bilstm_classifier(25, hidden=8, input_dim=5)
    m = BiLSTMClassifier(hidden=8, input_dim=5)
    m.load_state_dict(flax_to_torch_bilstm_classifier(v))
    x = np.random.default_rng(26).standard_normal((20, 5)).astype(np.float32)
    got = xai.compare_gmm_bilstm(x, bilstm_model=m, gmm_score_fn=score, ig_steps=4, shap_coalitions=16)
    ref = jcompare.compare_gmm_bilstm(x, bilstm_apply=JBiLSTMClassifier(hidden=8).apply, bilstm_variables=v,
                                      gmm_score_fn=jscore, ig_steps=4, shap_coalitions=16)
    for part in ("heatmaps", "importance"):
        assert set(got[part]) == set(ref[part])
        for k, a in got[part].items():
            tol = SHAP_TOL if k == "gmm_shap" else GRAD_RTOL
            np.testing.assert_allclose(a, ref[part][k], rtol=tol, atol=tol * np.abs(ref[part][k]).max(), err_msg=k)


def test_extract_top_intervals_matches_jax():
    hm = np.zeros((63, 19))
    hm[10:25] = 0.5
    hm[40:43] = 0.9
    hm[50:60] = 0.2
    assert xai.extract_top_intervals_global(hm, top_n=3) == jcompare.extract_top_intervals_global(hm, top_n=3)


def _no_matplotlib(monkeypatch):
    for name in [n for n in sys.modules if n == "matplotlib" or n.startswith("matplotlib.")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "matplotlib", None)


@pytest.mark.parametrize("have", [True, False])
def test_plots_and_report(tmp_path, monkeypatch, capsys, have):
    """With matplotlib every plot writes its PNG; without it (the card
    machine) each skips with one stderr line and returns no path, and the
    HTML page is written with its images left out."""
    if not have:
        _no_matplotlib(monkeypatch)
    rng = np.random.default_rng(27)
    hms = {"a": rng.random((20, 8)), "b": rng.random((20, 8))}
    orig = rng.standard_normal((8, 20))
    pert, mask = features_mean_from_scores(torch.from_numpy(orig), torch.from_numpy(rng.random(8)), n_changed=2)
    paths = [
        *xai.plot_heatmaps(hms, str(tmp_path), prefix="u"),
        xai.visualize_feature_perturbation(orig, pert, mask, out_path=str(tmp_path / "f.png")),
        xai.visualize_segment_perturbation(orig, orig, np.ones(4), out_path=str(tmp_path / "s.png")),
        xai.plot_cqcc_pipeline(orig, pert, {"mode": "feature", "mask": mask}, out_path=str(tmp_path / "c.png")),
        xai.plot_gradcam_overlay(rng.random((16, 12)), torch.rand(6, 4), out_path=str(tmp_path / "g.png")),
    ]
    html = xai.write_explanation_html(str(tmp_path / "e.html"), score=0.7, heatmaps=hms, top_components=[1, 0],
                                      coefficients=np.array([0.5, -0.25]))
    page = open(html).read()
    assert "SPOOF" in page and "+0.5000" in page
    err = capsys.readouterr().err
    if have:
        assert len(paths) == 6 and all((tmp_path / p).exists() for p in paths)
        assert page.count("data:image/png;base64,") == 2 and not err
    else:
        assert paths == [None] * 4 and "data:image/png" not in page
        assert err.count("matplotlib is not installed") == 6  # five plots and the page
