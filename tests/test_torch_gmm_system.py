"""The port's GMM-UBM system against the JAX package's, on the CPU.

JAX trains a tiny system in the test (``train_gmm_system``: few components
and EM iterations) and saves a small ``BiLSTMClassifier`` with
``save_checkpoint`` as ``best_model.msgpack``. The port's
``load_bilstm_model`` and ``eval_model`` on that dir must reproduce JAX's
``eval_model``: the same ``y_pred``, accuracy and F1 exactly, and the EER
within 1e-6. The port's ``train_gmm_system`` on the same frames writes the
npz files JAX writes (within fp32 summation order), both packages score the
dir it wrote alike, and ``eval_model``'s training branch matches JAX's.
"""

import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audioanalysisdetector_tpu.models.bilstm_classifier import BiLSTMClassifier as JBiLSTMClassifier
from audioanalysisdetector_tpu.train import gmm_system as jsys
from audioanalysisdetector_tpu.train.checkpoint import save_checkpoint
from audioanalysisdetector_tpu_torch.convert import flax_to_torch_bilstm_classifier
from audioanalysisdetector_tpu_torch.models.bilstm_classifier import BiLSTMClassifier
from audioanalysisdetector_tpu_torch.models.gmm import to_numpy
from audioanalysisdetector_tpu_torch.train import gmm_system as tsys

torch.set_num_threads(2)

# the EER of two score vectors that agree within the fused scorer's 1e-5
# and rank the test rows the same way
EER_TOL = 1e-6
# GMM parameters trained by both packages on the same frames, relative to
# each array's largest entry: fp32 EM statistics summed in other orders
# (deltas and CMVN computed on each side first)
GMM_RTOL = 1e-4
HIDDEN, D, T = 16, 19, 24


def _data(n: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """(n, T, D) features whose class shifts their mean and scale."""
    rng = np.random.default_rng(seed)
    y = np.arange(n) % 2
    x = rng.standard_normal((n, T, D)) * (1.0 + 0.3 * y[:, None, None]) + 0.4 * y[:, None, None]
    return x.astype(np.float32), y


def _clustered(n: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """``_data`` around four well-separated centres, so EM in both packages
    assigns the same components at every iteration (on ``_data`` alone the
    components overlap and fp32 rounding moves the fit)."""
    x, y = _data(n, seed)
    centres = np.random.default_rng(99).standard_normal((4, D)) * 4
    c = np.random.default_rng(seed + 100).integers(0, 4, (n, T))
    return (x + centres[c]).astype(np.float32), y


@pytest.fixture(scope="module", params=["raw", "deltas_cmvn"])
def model_dir(request, tmp_path_factory):
    d = tmp_path_factory.mktemp(request.param)
    x, y = _data(40, seed=1)
    flags = dict(deltas=True, cmvn=True) if request.param == "deltas_cmvn" else {}
    jsys.train_gmm_system(x, y, n_components=4, max_iter=5, model_dir=str(d), seed=0, **flags)
    params = JBiLSTMClassifier(hidden=HIDDEN).init(jax.random.PRNGKey(3), jnp.zeros((1, T, D)))["params"]
    save_checkpoint(str(d / "bilstm" / "best_model.msgpack"), types.SimpleNamespace(params=params))
    return str(d)


def test_eval_model_reproduces_jax(model_dir):
    x, y = _data(30, seed=2)
    jmodel, jvars = jsys.load_bilstm_model(model_dir, hidden=HIDDEN)
    ref = jsys.eval_model(jmodel.apply, jvars, None, None, x, y, model_dir=model_dir,
                          batch_size=16, verbose=False)
    model = tsys.load_bilstm_model(model_dir, hidden=HIDDEN, device="cpu")
    ours = tsys.eval_model(model, None, None, x, y, model_dir=model_dir, batch_size=16,
                           verbose=False, device="cpu")
    np.testing.assert_array_equal(ours[0], ref[0])
    np.testing.assert_array_equal(ours[1], ref[1])
    assert ours[2]["accuracy"] == ref[2]["accuracy"] and ours[2]["f1"] == ref[2]["f1"]
    assert abs(ours[2]["eer"] - ref[2]["eer"]) <= EER_TOL
    assert 0 < ours[1].sum() < len(y)  # both classes predicted: the comparison shows something


def test_loaders_read_what_jax_wrote(model_dir):
    gmms = tsys.load_gmm_models(model_dir, device="cpu")
    jgmms = jsys.load_gmm_models(model_dir)
    for ours, ref in zip(gmms, jgmms):
        back = to_numpy(ours)
        assert all(back[k].tobytes() == np.asarray(getattr(ref, k)).tobytes() for k in back)
    fn, jfn = tsys.load_gmm_feature_fn(model_dir), jsys.load_gmm_feature_fn(model_dir)
    assert (fn is None) == (jfn is None)
    if fn is not None:
        x, _ = _data(3, seed=4)
        np.testing.assert_allclose(fn(torch.from_numpy(x)).numpy(), np.asarray(jfn(jnp.asarray(x))),
                                   rtol=0, atol=1e-5)


def test_load_bilstm_model_refuses_another_width(model_dir, tmp_path):
    with pytest.raises(ValueError, match=r"BiLSTMClassifier\(hidden=32, input_dim=19\)"):
        tsys.load_bilstm_model(model_dir, hidden=32, device="cpu")
    with pytest.raises(ValueError, match="does not match"):
        tsys.load_bilstm_model(model_dir, hidden=HIDDEN, input_dim=20, device="cpu")
    with pytest.raises(FileNotFoundError, match="best_model.msgpack"):
        tsys.load_bilstm_model(str(tmp_path), device="cpu")


GMM_FILES = ("ubm", "gmm_genuine", "gmm_df")
SYSTEMS = {"plain": {}, "deltas": dict(deltas=True), "cmvn": dict(cmvn=True),
           "full": dict(adapt_mode="full", deltas=True, cmvn=True)}


def _assert_same_gmm_dirs(ours: str, ref: str):
    for name in GMM_FILES:
        with np.load(os.path.join(ours, f"{name}.npz")) as a, np.load(os.path.join(ref, f"{name}.npz")) as b:
            assert sorted(a.files) == sorted(b.files) == ["means", "variances", "weights"]
            for k in b.files:
                assert a[k].dtype == b[k].dtype == np.float32 and a[k].shape == b[k].shape
                np.testing.assert_allclose(a[k], b[k], rtol=0, atol=GMM_RTOL * np.abs(b[k]).max(),
                                           err_msg=f"{name}.{k}")
    with open(os.path.join(ours, "feature_transform.json")) as f, \
            open(os.path.join(ref, "feature_transform.json")) as g:
        assert json.load(f) == json.load(g)


@pytest.mark.parametrize("system", sorted(SYSTEMS))
def test_train_gmm_system_matches_jax(system, tmp_path):
    x, y = _clustered(40, seed=6)
    kw = dict(n_components=4, max_iter=20, seed=1, **SYSTEMS[system])
    ref = jsys.train_gmm_system(x, y, model_dir=str(tmp_path / "jax"), **kw)
    ours = tsys.train_gmm_system(x, y, model_dir=str(tmp_path / "port"), device="cpu", **kw)
    _assert_same_gmm_dirs(str(tmp_path / "port"), str(tmp_path / "jax"))
    for o, r in zip(ours, ref):  # the returned models are the saved ones
        for k, v in to_numpy(o).items():
            np.testing.assert_allclose(v, np.asarray(getattr(r, k)), rtol=0, atol=GMM_RTOL * np.abs(v).max())


@pytest.fixture(scope="module", params=["raw", "deltas_cmvn"])
def port_dir(request, tmp_path_factory):
    """A model dir the port's ``train_gmm_system`` wrote, with a JAX BiLSTM checkpoint."""
    d = tmp_path_factory.mktemp("port_" + request.param)
    x, y = _data(40, seed=1)
    flags = dict(deltas=True, cmvn=True) if request.param == "deltas_cmvn" else {}
    tsys.train_gmm_system(x, y, n_components=4, max_iter=5, model_dir=str(d), seed=0, device="cpu", **flags)
    params = JBiLSTMClassifier(hidden=HIDDEN).init(jax.random.PRNGKey(3), jnp.zeros((1, T, D)))["params"]
    save_checkpoint(str(d / "bilstm" / "best_model.msgpack"), types.SimpleNamespace(params=params))
    return str(d)


def test_jax_scores_what_the_port_trained(port_dir):
    """JAX's loaders read the port's dir, and both packages' ``eval_model``
    on it agree as on a dir JAX wrote."""
    test_eval_model_reproduces_jax(port_dir)
    for ours, ref in zip(tsys.load_gmm_models(port_dir, device="cpu"), jsys.load_gmm_models(port_dir)):
        back = to_numpy(ours)
        assert all(back[k].tobytes() == np.asarray(getattr(ref, k)).tobytes() for k in back)


def test_eval_model_training_branch_matches_jax(tmp_path):
    """No saved GMMs: both packages train them from the train split (the
    identity transform, ``n_components``) and score the test split alike."""
    x, y = _clustered(40, seed=7)
    xt, yt = _clustered(30, seed=8)
    variables = JBiLSTMClassifier(hidden=HIDDEN).init(jax.random.PRNGKey(5), jnp.zeros((1, T, D)))
    ref = jsys.eval_model(JBiLSTMClassifier(hidden=HIDDEN).apply, variables, x, y, xt, yt,
                          model_dir=str(tmp_path / "jax"), n_components=4, batch_size=16, verbose=False)
    model = BiLSTMClassifier(hidden=HIDDEN, input_dim=D)
    model.load_state_dict(flax_to_torch_bilstm_classifier(variables))
    ours = tsys.eval_model(model, x, y, xt, yt, model_dir=str(tmp_path / "port"), n_components=4,
                           batch_size=16, verbose=False, device="cpu")
    _assert_same_gmm_dirs(str(tmp_path / "port"), str(tmp_path / "jax"))
    np.testing.assert_array_equal(ours[1], ref[1])
    assert ours[2]["accuracy"] == ref[2]["accuracy"] and ours[2]["f1"] == ref[2]["f1"]
    assert abs(ours[2]["eer"] - ref[2]["eer"]) <= EER_TOL
    with pytest.raises(ValueError, match="train data required"):
        tsys.eval_model(model, None, None, xt, yt, model_dir=str(tmp_path / "empty"), device="cpu")
