"""The port's classical-ML estimators (``ml/``) on the CPU against scikit-learn.

The port carries its own sklearn (it depends on no scikit-learn): each
estimator here is held to sklearn 1.9 on the same numpy inputs. Bounds:

- splits, folds, ``ParameterGrid`` order and the boosted trees' bin
  thresholds: bitwise (the same numpy draws and arithmetic);
- ``StandardScaler``: 1e-12 absolute (float64 sums in torch's order, not
  numpy's pairwise order: a few ulps);
- ``PCA`` transforms: 1e-9 of their largest entry (float64 ``eigh`` or SVD
  through another LAPACK path; the components' signs by the same rule);
- ``FastICA`` sources: 1e-6 absolute, with the same ``n_iter_`` (the same
  fixed-point iteration from the same ``w_init``; rounding in the
  whitening SVD and the decorrelations);
- ``SVC`` decision values: 2e-3 absolute against sklearn's default
  ``tol=1e-3``, where libsvm stops short of the optimum by up to ~7.5e-4
  on the rbf problem here (the port runs to 1e-5); predictions equal
  wherever ``|decision| > 2e-3``. On the linear problem libsvm at 1e-3
  stops ~1e-2 from the optimum (it crawls on the flat directions of a
  rank-deficient kernel), so the linear case is held to sklearn run to
  ``tol=1e-7``, with the same 2e-3;
- boosted trees ``predict_proba``: 1e-6 absolute, equal ``n_iter_`` (float64
  histogram sums; the same splits).
"""

import warnings

import numpy as np
import pytest
import torch
from sklearn import decomposition as skd
from sklearn import ensemble as ske
from sklearn import metrics as skmetrics
from sklearn import model_selection as skms
from sklearn import preprocessing as skp
from sklearn import svm as sksvm

from audioanalysisdetector_tpu_torch import ml

torch.set_num_threads(2)

SCALER_TOL = 1e-12
PCA_RTOL = 1e-9
ICA_TOL = 1e-6
SVC_TOL = 2e-3
HGB_TOL = 1e-6


def _labels(n, rng, p=0.5):
    y = (rng.random(n) < p).astype(np.int64)
    y[:2] = [0, 1]
    return y


@pytest.mark.parametrize("n, p, test_size, seed", [(103, 0.5, 0.2, 0), (250, 0.1, 0.2, 42), (61, 0.3, 0.25, 7),
                                                    (40, 0.5, 5, 3)])
def test_train_test_split_bitwise(n, p, test_size, seed):
    rng = np.random.default_rng(seed)
    X, y = rng.standard_normal((n, 3)), _labels(n, rng, p)
    for stratify in (y, None):
        ours = ml.train_test_split(X, y, test_size=test_size, stratify=stratify, random_state=seed)
        ref = skms.train_test_split(X, y, test_size=test_size, stratify=stratify, random_state=seed)
        for a, b in zip(ours, ref):
            np.testing.assert_array_equal(a, b)
    rows = [{"i": i} for i in range(n)]
    ours = ml.train_test_split(rows, test_size=test_size, random_state=seed)
    ref = skms.train_test_split(np.arange(n), test_size=test_size, random_state=seed)
    assert [r["i"] for r in ours[0]] == ref[0].tolist() and [r["i"] for r in ours[1]] == ref[1].tolist()


@pytest.mark.parametrize("n_splits, shuffle, seed", [(3, False, None), (3, True, 42), (5, True, 0), (2, False, None)])
def test_stratified_kfold_bitwise(n_splits, shuffle, seed):
    rng = np.random.default_rng(11)
    y = np.array(["spoof", "bonafide", "spoof"])[rng.integers(0, 3, 77)]
    ours = list(ml.StratifiedKFold(n_splits, shuffle=shuffle, random_state=seed).split(None, y))
    ref = list(skms.StratifiedKFold(n_splits, shuffle=shuffle, random_state=seed).split(np.zeros(77), y))
    assert len(ours) == len(ref) == n_splits
    for (tr, te), (rtr, rte) in zip(ours, ref):
        np.testing.assert_array_equal(tr, rtr)
        np.testing.assert_array_equal(te, rte)


def test_parameter_grid_order():
    grid = {"clf__C": [1, 10], "pca__n_components": [10, 20, 30], "clf__gamma": ["scale", 0.1]}
    assert list(ml.ParameterGrid(grid)) == list(skms.ParameterGrid(grid))
    assert len(ml.ParameterGrid(grid)) == 12
    assert list(ml.ParameterGrid([grid, {"a": [1]}])) == list(skms.ParameterGrid([grid, {"a": [1]}]))


def _svc_problem(n, seed, d=6):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d))
    y = (X[:, 0] + 0.6 * X[:, 1] ** 2 + 0.5 * rng.standard_normal(n) > 0.5).astype(np.int64)
    return X, y, rng.standard_normal((300, d))


def test_grid_search_best_params_score_and_ties():
    X, y, _ = _svc_problem(150, 1)
    grid = {"C": [0.5, 1, 10], "gamma": ["scale", 0.05]}
    ours = ml.GridSearchCV(ml.SVC(device="cpu"), grid, cv=3).fit(X, y)
    ref = skms.GridSearchCV(sksvm.SVC(), grid, cv=3).fit(X, y)
    assert ours.best_params_ == ref.best_params_
    assert ours.best_score_ == ref.best_score_
    np.testing.assert_array_equal(ours.cv_results_["rank_test_score"], ref.cv_results_["rank_test_score"])
    np.testing.assert_array_equal(ours.cv_results_["mean_test_score"], ref.cv_results_["mean_test_score"])
    # every candidate ties on separable data: the first in grid order wins
    Xs = np.r_[np.zeros((30, 2)), np.ones((30, 2)) * 5] + np.random.default_rng(2).normal(0, 0.1, (60, 2))
    ys = np.r_[np.zeros(30, int), np.ones(30, int)]
    tie = {"C": [10, 1, 0.1], "kernel": ["rbf", "linear"]}
    ours = ml.GridSearchCV(ml.SVC(device="cpu"), tie, cv=3).fit(Xs, ys)
    ref = skms.GridSearchCV(sksvm.SVC(), tie, cv=3).fit(Xs, ys)
    assert (ref.cv_results_["mean_test_score"] == 1.0).all()
    assert ours.best_params_ == ref.best_params_ == {"C": 10, "kernel": "rbf"}
    assert ours.best_index_ == ref.best_index_ == 0


def test_grid_search_failed_fits_score_nan():
    """A candidate whose fit raises (PCA wider than a fold) scores NaN and
    ranks last, as sklearn's ``error_score=np.nan``."""
    X, y, _ = _svc_problem(30, 3, d=12)
    grid = {"pca__n_components": [25, 4], "clf__C": [1]}
    ours = ml.GridSearchCV(ml.Pipeline([("pca", ml.PCA(device="cpu")), ("clf", ml.SVC(device="cpu"))]),
                           grid, cv=3)
    with pytest.warns(UserWarning):
        ours.fit(X, y)
    from sklearn.pipeline import Pipeline as SkPipeline

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = skms.GridSearchCV(SkPipeline([("pca", skd.PCA()), ("clf", sksvm.SVC())]), grid, cv=3).fit(X, y)
    assert np.isnan(ours.cv_results_["mean_test_score"][0]) and np.isnan(ref.cv_results_["mean_test_score"][0])
    np.testing.assert_array_equal(ours.cv_results_["rank_test_score"], ref.cv_results_["rank_test_score"])
    assert ours.best_params_ == ref.best_params_ and ours.best_score_ == ref.best_score_


def test_standard_scaler():
    rng = np.random.default_rng(4)
    X = rng.standard_normal((500, 9)) * rng.uniform(0.01, 50, 9) + rng.uniform(-100, 100, 9)
    X[:, 3] = 7.25  # a constant column scales by 1
    ours = ml.StandardScaler(device="cpu").fit(X)
    ref = skp.StandardScaler().fit(X)
    for a in ("mean_", "var_", "scale_"):
        np.testing.assert_allclose(getattr(ours, a).numpy(), getattr(ref, a), rtol=SCALER_TOL, atol=0)
    assert ours.scale_[3] == 1.0
    Xq = rng.standard_normal((40, 9))
    np.testing.assert_allclose(ours.transform(Xq), ref.transform(Xq), rtol=0, atol=SCALER_TOL)
    np.testing.assert_allclose(ours.fit_transform(X), ref.fit_transform(X), rtol=0, atol=SCALER_TOL)


@pytest.mark.parametrize("shape, k, solver", [((900, 30), 10, "covariance_eigh"), ((120, 25), 8, "full"),
                                              ((300, 200), 40, "full")])
def test_pca(shape, k, solver):
    rng = np.random.default_rng(5)
    X = rng.standard_normal(shape) @ rng.standard_normal((shape[1], shape[1])) + 3.0
    ours = ml.PCA(k, random_state=0, device="cpu").fit(X)
    ref = skd.PCA(k, random_state=0).fit(X)
    assert ours._fit_svd_solver == solver
    if ref._fit_svd_solver != "randomized":  # the port stays exact where sklearn would approximate
        assert ref._fit_svd_solver == solver
        np.testing.assert_allclose(ours.components_.numpy(), ref.components_, rtol=0, atol=PCA_RTOL)
    Xq = rng.standard_normal((50, shape[1])) @ rng.standard_normal((shape[1], shape[1]))
    exact = skd.PCA(k, svd_solver="full").fit(X)
    for got, want in ((ours.transform(Xq), exact.transform(Xq)), (ours.fit_transform(X), exact.fit_transform(X))):
        assert np.abs(got - want).max() <= PCA_RTOL * np.abs(want).max()
    np.testing.assert_allclose(ours.explained_variance_.numpy(), exact.explained_variance_, rtol=PCA_RTOL)
    np.testing.assert_allclose(ours.explained_variance_ratio_.numpy(), exact.explained_variance_ratio_, rtol=PCA_RTOL)
    np.testing.assert_allclose(ours.noise_variance_, exact.noise_variance_, rtol=PCA_RTOL)


@pytest.mark.parametrize("k, seed", [(5, 42), (8, 0)])
def test_fastica(k, seed):
    rng = np.random.default_rng(6)
    S = rng.laplace(size=(700, 10))
    X = S @ rng.standard_normal((10, 10)) + 1.0
    ours = ml.FastICA(k, random_state=seed, device="cpu").fit(X)
    ref = skd.FastICA(k, random_state=seed).fit(X)
    assert ours.n_iter_ == ref.n_iter_ and ours.n_iter_ < 200
    np.testing.assert_allclose(ours.transform(X), ref.transform(X), rtol=0, atol=ICA_TOL)
    np.testing.assert_allclose(ours.fit_transform(X), ref.fit_transform(X), rtol=0, atol=ICA_TOL)
    np.testing.assert_allclose(ours.mixing_.numpy(), ref.mixing_, rtol=0, atol=ICA_TOL * np.abs(ref.mixing_).max())


@pytest.mark.parametrize("kernel, C, n, ref_tol", [("rbf", 1.0, 400, 1e-3), ("rbf", 10.0, 300, 1e-3),
                                                   ("linear", 1.0, 200, 1e-7)])
def test_svc_decision_values(kernel, C, n, ref_tol):
    X, y, Xq = _svc_problem(n, 7)
    y = np.where(y == 1, "spoof", "bonafide")  # any two labels: classes_[1] is the positive side
    ours = ml.SVC(C=C, kernel=kernel, probability=True, device="cpu").fit(X, y)
    ref = sksvm.SVC(C=C, kernel=kernel, tol=ref_tol).fit(X, y)
    np.testing.assert_array_equal(ours.classes_, ref.classes_)
    d_ours, d_ref = ours.decision_function(Xq), ref.decision_function(Xq)
    assert np.abs(d_ours - d_ref).max() <= SVC_TOL
    sure = np.abs(d_ref) > SVC_TOL
    np.testing.assert_array_equal(ours.predict(Xq)[sure], ref.predict(Xq)[sure])
    np.testing.assert_allclose(ours.intercept_, ref.intercept_, atol=SVC_TOL)
    # the same support vectors, listed by class then index, and y * alpha
    assert set(ours.support_[np.abs(ours.dual_coef_[0]) > 1e-3 * C]) <= set(ref.support_)
    assert (np.sign(ours.dual_coef_[0]) == np.where(y[ours.support_] == ref.classes_[1], 1, -1)).all()
    assert (np.diff(ours.support_[: ours.n_support_[0]]) > 0).all()
    assert ours.n_iter_[0] > 0


def test_svc_gamma_scale_and_one_class():
    X, y, _ = _svc_problem(80, 8)
    # X.var() summed in torch's order: a few ulps from numpy's
    np.testing.assert_allclose(ml.SVC(device="cpu").fit(X, y)._gamma, sksvm.SVC().fit(X, y)._gamma, rtol=1e-12)
    with pytest.raises(ValueError):
        ml.SVC(device="cpu").fit(X, np.zeros(80))


def _hgb_problem(n, seed):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, 5))
    X[:, 1] = np.round(X[:, 1], 1)  # few distinct values: midpoint thresholds
    X[:, 4] = rng.integers(0, 3, n)  # three values
    y = (X[:, 0] + np.sin(3 * X[:, 2]) + 0.5 * X[:, 4] + 0.4 * rng.standard_normal(n) > 0.5).astype(np.int64)
    return X, y, rng.standard_normal((200, 5))


@pytest.mark.parametrize("n, kwargs", [(700, {}), (700, {"max_depth": 3, "max_iter": 50}),
                                       (900, {"max_depth": 5, "learning_rate": 0.05, "max_iter": 60})])
def test_hist_gradient_boosting(n, kwargs):
    X, y, Xq = _hgb_problem(n, 9)
    ours = ml.HistGradientBoostingClassifier(random_state=42, device="cpu", **kwargs).fit(X, y)
    ref = ske.HistGradientBoostingClassifier(random_state=42, **kwargs).fit(X, y)
    assert len(ours.bin_thresholds_) == len(ref._bin_mapper.bin_thresholds_)
    for a, b in zip(ours.bin_thresholds_, ref._bin_mapper.bin_thresholds_):
        np.testing.assert_array_equal(a, b)
    assert ours.n_iter_ == ref.n_iter_ and not ours.do_early_stopping_
    np.testing.assert_allclose(ours.predict_proba(Xq), ref.predict_proba(Xq), rtol=0, atol=HGB_TOL)
    np.testing.assert_allclose(ours.decision_function(Xq), ref.decision_function(Xq), rtol=0, atol=10 * HGB_TOL)
    np.testing.assert_array_equal(ours.predict(Xq), ref.predict(Xq))
    leaves = [sum(p.nodes["is_leaf"]) for (p,) in ref._predictors]
    assert ours.n_leaves_ == leaves


def test_hist_gradient_boosting_early_stopping():
    """Above 10,000 rows: a stratified 10% validation split seeded from
    ``RandomState(random_state)``, stopping on the validation loss."""
    X, y, Xq = _hgb_problem(10_500, 10)
    ours = ml.HistGradientBoostingClassifier(random_state=3, device="cpu").fit(X, y)
    ref = ske.HistGradientBoostingClassifier(random_state=3).fit(X, y)
    assert ours.do_early_stopping_ and ref.do_early_stopping_
    assert ours.n_iter_ == ref.n_iter_ < 100
    np.testing.assert_allclose(ours.validation_score_, ref.validation_score_, rtol=1e-12)
    np.testing.assert_allclose(ours.predict_proba(Xq), ref.predict_proba(Xq), rtol=0, atol=HGB_TOL)


def test_binning_thresholds_past_max_bins():
    rng = np.random.default_rng(12)
    col = rng.standard_normal(3000)
    col[:500] = np.round(col[:500], 2)
    from sklearn.ensemble._hist_gradient_boosting.binning import _find_binning_thresholds

    from audioanalysisdetector_tpu_torch.ml.hist_gbdt import find_binning_thresholds

    for max_bins in (255, 16):
        np.testing.assert_array_equal(find_binning_thresholds(col.copy(), max_bins),
                                      _find_binning_thresholds(col.copy(), max_bins))
    assert find_binning_thresholds(np.full(10, 2.0), 255).size == 0


def test_metrics():
    rng = np.random.default_rng(13)
    y, p = rng.integers(0, 2, 50), rng.integers(0, 2, 50)
    assert ml.accuracy_score(y, p) == skmetrics.accuracy_score(y, p)
    assert ml.f1_score(y, p) == skmetrics.f1_score(y, p)
    for pred in (p, np.zeros(50, int)):  # the second never predicts class 1: zero_division 0
        ours = ml.classification_report(y, pred, output_dict=True)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            ref = skmetrics.classification_report(y, pred, output_dict=True)
        for key in ("weighted avg", "macro avg", "0", "1"):
            for m in ("precision", "recall", "f1-score", "support"):
                assert ours[key][m] == ref[key][m], (key, m)
        assert ours["accuracy"] == ref["accuracy"]
    assert ml.f1_score(y, np.zeros(50, int)) == 0.0
    assert "weighted avg" in ml.classification_report(y, p)


def test_pipeline_params_and_prefix_cache(tmp_path, monkeypatch):
    X, y, Xq = _svc_problem(120, 14, d=8)
    pipe = ml.Pipeline([("scaler", ml.StandardScaler(device="cpu")), ("pca", ml.PCA(4, device="cpu")),
                        ("clf", ml.SVC(device="cpu"))], memory=ml.FitCache(str(tmp_path / "cache")))
    assert pipe.get_params()["pca__n_components"] == 4
    pipe.set_params(pca__n_components=3, clf__C=2.0)
    assert pipe.named_steps["pca"].n_components == 3 and pipe.named_steps["clf"].C == 2.0
    clone = ml.clone(pipe)
    assert clone.named_steps["clf"] is not pipe.named_steps["clf"] and clone.get_params()["clf__C"] == 2.0
    fits = []
    real = ml.PCA._fit_transform_t
    monkeypatch.setattr(ml.PCA, "_fit_transform_t", lambda self, X: fits.append(1) or real(self, X))
    pipe.fit(X, y)
    first = pipe.decision_function(Xq)
    assert len(fits) == 1 and len(list((tmp_path / "cache").glob("*.npz"))) == 2
    # another classifier candidate on the same rows reuses the fitted prefix
    ml.clone(pipe).set_params(clf__C=5.0).fit(X, y)
    assert len(fits) == 1
    # a later run (a new cache over the same directory) reads the npz files
    again = ml.clone(pipe).set_params(memory=str(tmp_path / "cache")).fit(X, y)
    assert len(fits) == 1
    np.testing.assert_array_equal(again.decision_function(Xq), first)
    # other rows or other prefix parameters fit anew
    ml.clone(pipe).fit(X[:100], y[:100])
    ml.clone(pipe).set_params(pca__n_components=2).fit(X, y)
    assert len(fits) == 3
    # no memory: no cache
    ml.Pipeline([("pca", ml.PCA(3, device="cpu")), ("clf", ml.SVC(device="cpu"))]).fit(X, y)
    ml.Pipeline([("pca", ml.PCA(3, device="cpu")), ("clf", ml.SVC(device="cpu"))]).fit(X, y)
    assert len(fits) == 5


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the behaviour without a CUDA device")
@pytest.mark.parametrize("make", [
    lambda: ml.StandardScaler(), lambda: ml.PCA(2), lambda: ml.FastICA(2), lambda: ml.SVC(),
    lambda: ml.HistGradientBoostingClassifier(max_iter=2),
    lambda: ml.Pipeline([("pca", ml.PCA(2)), ("clf", ml.SVC())]),
])
def test_estimators_on_cuda_raise_without_a_card(make):
    X, y, _ = _svc_problem(60, 15)
    with pytest.raises((RuntimeError, AssertionError)):
        make().fit(X, y)
