"""The port's GMM-UBM system, load and evaluation side, on a model dir JAX wrote.

JAX trains a tiny system in the test (``train_gmm_system``: few components
and EM iterations) and saves a small ``BiLSTMClassifier`` with
``save_checkpoint`` as ``best_model.msgpack``. The port's
``load_bilstm_model`` and ``eval_model`` on that dir must reproduce JAX's
``eval_model``: the same ``y_pred``, accuracy and F1 exactly, and the EER
within 1e-6.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audioanalysisdetector_tpu.models.bilstm_classifier import BiLSTMClassifier as JBiLSTMClassifier
from audioanalysisdetector_tpu.train import gmm_system as jsys
from audioanalysisdetector_tpu.train.checkpoint import save_checkpoint
from audioanalysisdetector_tpu_torch.models.gmm import to_numpy
from audioanalysisdetector_tpu_torch.train import gmm_system as tsys

torch.set_num_threads(2)

# the EER of two score vectors that agree within the fused scorer's 1e-5
# and rank the test rows the same way
EER_TOL = 1e-6
HIDDEN, D, T = 16, 19, 24


def _data(n: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """(n, T, D) features whose class shifts their mean and scale."""
    rng = np.random.default_rng(seed)
    y = np.arange(n) % 2
    x = rng.standard_normal((n, T, D)) * (1.0 + 0.3 * y[:, None, None]) + 0.4 * y[:, None, None]
    return x.astype(np.float32), y


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


def test_eval_model_training_branch_is_not_ported(tmp_path):
    x, y = _data(4, seed=5)
    with pytest.raises(NotImplementedError, match="Queue 1 step 8"):
        tsys.eval_model(torch.nn.Identity(), x, y, x, y, model_dir=str(tmp_path), device="cpu")
