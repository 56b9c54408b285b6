"""The port's classical path (``train/classical.py``, the classical helpers of
``data/``) on the CPU against the JAX package's (pandas + scikit-learn).

Bounds:

- ``expand_feature_columns``, ``to_array_safe``, ``build_X_from_df`` and
  ``prepare_train_test_data_multi``: bitwise (the same numpy arithmetic);
- ``preprocess_for_modeling``: the split, the oversampled rows and the
  labels bitwise; the scaled values within 1e-12 (the port's scaler sums in
  torch's order, sklearn's in numpy's pairwise order: a few ulps);
- ``run_extensive_gridsearch``: the two CSVs byte for byte (the same rows
  in the same order, tied scores included, the same scores). This needs
  every fit of the sweep to predict the same labels in both packages:
  libsvm stops up to ~1e-3 short of the SVM optimum (tests/test_torch_ml.py),
  so a point that close to a boundary may go either way; on these data
  none is. The ordering and the writing of tied rows are also held to
  pandas on constructed rows, whatever the fits;
- ``classical_main`` and ``train_gridsearch``: equal row counts, best
  parameters and accuracies. The two packages' extractors agree to ~1e-5
  of each feature (tests/test_torch_features.py) and the estimators to
  the bounds of tests/test_torch_ml.py; on these corpora no test
  prediction moves, so the accuracies are equal, not merely close.
"""

import os

import numpy as np
import pandas as pd
import pytest
import torch

from audioanalysisdetector_tpu.data.scaler import prepare_train_test_data_multi as j_prepare_multi
from audioanalysisdetector_tpu.data.shape_utils import build_X_from_df as j_build_X
from audioanalysisdetector_tpu.data.shape_utils import to_array_safe as j_to_array_safe
from audioanalysisdetector_tpu.train import classical as jc
from audioanalysisdetector_tpu_torch.data.scaler import prepare_train_test_data_multi
from audioanalysisdetector_tpu_torch.data.shape_utils import build_X_from_df, to_array_safe
from audioanalysisdetector_tpu_torch.data.synthetic import make_surrogate_corpus
from audioanalysisdetector_tpu_torch.train import classical as tc

torch.set_num_threads(2)

SCALED_TOL = 1e-12


def _rows(df: pd.DataFrame) -> list[dict]:
    return df.to_dict("records")


def _cells(n, rng):
    return {
        "vec": [rng.standard_normal(4).astype(np.float32) for _ in range(n)],
        "mat": [rng.standard_normal((2, 3)) for _ in range(n)],
        "dct": [{"b": float(rng.standard_normal()), "a": float(rng.standard_normal())} for _ in range(n)],
        "label": ["spoof", "bonafide"] * (n // 2),
    }


def test_expand_feature_columns_matches_jax():
    rng = np.random.default_rng(0)
    cells = _cells(12, rng)
    cells["vec"][3] = None  # a null cell
    cells["vec"][5] = np.array([1.0, np.nan, 2.0, 3.0])  # a NaN inside a vector
    cells["mat"][7] = np.zeros(4)  # a ragged vector: pandas pads it with NaN
    cells["dct"][9] = {"b": 1.0}  # a dict without "a"
    cells["dct"][10] = None
    df = pd.DataFrame(cells)
    want = jc.expand_feature_columns(df, ["vec", "mat", "dct"], "label")
    got = tc.expand_feature_columns(_rows(df), ["vec", "mat", "dct"], "label")
    assert len(got) == len(want) == 7
    assert list(got[0]) == list(want.columns)
    np.testing.assert_array_equal(np.array([[r[c] for c in want.columns[:-1]] for r in got]),
                                  want.drop(columns=["label"]).to_numpy(np.float64))
    assert [r["label"] for r in got] == want["label"].tolist()
    with pytest.raises(ValueError):
        tc.expand_feature_columns([{"x": None, "label": "spoof"}], ["x"], "label")


@pytest.mark.parametrize("n_spoof, n_bona, extra", [(40, 20, []), (13, 31, ["1", "SPOOF", "Bonafide", None])])
def test_preprocess_for_modeling_matches_jax(n_spoof, n_bona, extra):
    rng = np.random.default_rng(n_spoof)
    n = n_spoof + n_bona + len(extra)
    df = pd.DataFrame(rng.standard_normal((n, 5)) * [1, 10, 0.1, 5, 2] + 3, columns=list("abcde"))
    df["label"] = ["spoof"] * n_spoof + ["bonafide"] * n_bona + extra
    jXtr, jXte, jytr, jyte, jscaler = jc.preprocess_for_modeling(df)
    Xtr, Xte, ytr, yte, scaler = tc.preprocess_for_modeling(_rows(df), device="cpu")
    np.testing.assert_array_equal(ytr, jytr)
    np.testing.assert_array_equal(yte, jyte)
    assert Xtr.shape == jXtr.shape and Xte.shape == jXte.shape
    np.testing.assert_allclose(Xtr, jXtr, rtol=0, atol=SCALED_TOL)
    np.testing.assert_allclose(Xte, jXte, rtol=0, atol=SCALED_TOL)
    # the same rows, in the same order, before scaling
    np.testing.assert_allclose(scaler.inverse_transform(Xtr), jscaler.inverse_transform(jXtr), rtol=1e-13)


def _frame(n, seed):
    # Laplace columns: FastICA on Gaussian ones has no unique answer (its
    # iteration wanders and stops at max_iter, where rounding decides)
    rng = np.random.default_rng(seed)
    X = rng.laplace(size=(n, 6))
    y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(int)
    df = pd.DataFrame(X, columns=[f"f_{i}" for i in range(6)])
    df["label"] = y
    return df


@pytest.mark.parametrize("seed", [3, 9])
def test_run_extensive_gridsearch_csvs_match_jax(tmp_path, seed):
    df = _frame(64, seed)
    kw = dict(
        feature_groups={"f": ["f_0", "f_1", "f_2"], "g": ["f_3", "f_4", "f_5"]},
        svm_params={"clf__C": [1], "clf__kernel": ["rbf"]},
        xgb_params={"clf__n_estimators": [10], "clf__max_depth": [3], "clf__learning_rate": [0.1],
                    "clf__gamma": [0]},
        cv=3, components=(2,), top_k=4, n_jobs=1,
    )
    jtop, jfull = jc.run_extensive_gridsearch(df[:48], df[48:], out_dir=str(tmp_path / "jax"),
                                               cache_dir=str(tmp_path / "jcache"), **kw)
    top, full = tc.run_extensive_gridsearch(_rows(df[:48]), _rows(df[48:]), out_dir=str(tmp_path / "port"),
                                            cache_dir=str(tmp_path / "pcache"), device="cpu", **kw)
    assert len(full) == len(jfull) == 5 * 2 * 3 * 2 and len(top) == 4
    assert jfull["test_score"].duplicated().sum() > 10  # 16 test rows: most scores tie
    for name in ("gridsearch_summary.csv", "top_4_models.csv"):
        assert (tmp_path / "port" / name).read_text() == (tmp_path / "jax" / name).read_text(), name
    assert [r["best_params"] for r in full] == jfull["best_params"].tolist()
    assert os.listdir(tmp_path / "pcache")  # the prefix cache wrote its npz files


def test_summary_order_and_csv_match_pandas(tmp_path):
    """The sort (pandas' ``nargsort`` on tied scores) and the CSV writer
    against pandas on the same result rows: many ties, ``None`` cells,
    ints beside ``None`` (a float column in pandas), bools, JSON strings."""
    rng = np.random.default_rng(23)
    rows = []
    for k in range(40):
        reducer = [None, "pca", "ica"][k % 3]
        rows.append({"model": ["SVM", "XGB"][k % 2], "feature_set": f"fs{k % 4}", "std": bool(k % 5 < 2),
                     "reducer": reducer, "n_comp": None if reducer is None else int(rng.integers(2, 40)),
                     "train_score": float(rng.integers(0, 9) / 8), "test_score": float(rng.integers(0, 5) / 4),
                     "precision": float(rng.random()), "recall": 1 / 3, "f1": float(rng.random()),
                     "best_params": '{"clf__C": 1, "clf__kernel": "rbf"}'})
    df = pd.DataFrame(rows).sort_values("test_score", ascending=False).reset_index(drop=True)
    ordered = tc._sorted_by_test_score(rows)
    assert [r["feature_set"] + r["model"] + str(r["n_comp"]) for r in ordered] == \
        [a + b + ("None" if pd.isna(c) else str(int(c))) for a, b, c in zip(df["feature_set"], df["model"], df["n_comp"])]
    df.to_csv(tmp_path / "pandas.csv", index=False)
    df.head(5).to_csv(tmp_path / "pandas_top.csv", index=False)
    tc._write_csv(str(tmp_path / "port.csv"), ordered, rows)
    tc._write_csv(str(tmp_path / "port_top.csv"), ordered[:5], rows)
    assert (tmp_path / "port.csv").read_text() == (tmp_path / "pandas.csv").read_text()
    assert (tmp_path / "port_top.csv").read_text() == (tmp_path / "pandas_top.csv").read_text()


def test_generate_feature_sets_and_xgb_map():
    assert list(tc.generate_feature_sets(["a", "b", "c"])) == list(jc.generate_feature_sets(["a", "b", "c"]))
    assert tc._XGB_PARAM_MAP == jc._XGB_PARAM_MAP and tc.DEFAULT_XGB_PARAMS == jc.DEFAULT_XGB_PARAMS
    assert tc.LABEL_MAP == jc.LABEL_MAP and tc.CLASSICAL_FEATURES == jc.CLASSICAL_FEATURES
    clf, param_map = tc._xgb_like(0, device="cpu")
    jclf, _ = jc._xgb_like(0)
    assert param_map is tc._XGB_PARAM_MAP
    for k in ("max_iter", "max_depth", "learning_rate", "max_leaf_nodes", "min_samples_leaf", "l2_regularization",
              "max_bins", "early_stopping", "validation_fraction", "n_iter_no_change", "tol", "random_state"):
        assert clf.get_params()[k] == jclf.get_params()[k], k
    pipe = tc.make_search_pipeline("ica", 3, True, clf, device="cpu")
    jpipe = jc.make_search_pipeline("ica", 3, True, jclf)
    assert [n for n, _ in pipe.steps] == [n for n, _ in jpipe.steps]
    assert pipe.get_params()["reducer__n_components"] == 3


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("classical")
    return make_surrogate_corpus(str(d / "c"), n_bonafide=20, n_spoof_per_tier=6, seconds=1.0, seed=7,
                                 subset="train")


def test_classical_main_matches_jax(corpus, tmp_path):
    meta, flac = corpus
    kw = dict(seconds=1.0, features=("mfcc", "wpt", "formants"), pca_components=(4, 8), n_estimators=(10,),
              max_depth=(3,), cv=2, verbose=False)
    want = jc.classical_main({"LA": {"metadata": meta, "flac": [flac]}}, cache_dir=str(tmp_path / "j"), **kw)
    got = tc.classical_main({"LA": {"metadata": meta, "flac": [flac]}}, cache_dir=str(tmp_path / "t"),
                            device="cpu", **kw)
    assert (got["n_train"], got["n_test"]) == (want["n_train"], want["n_test"])
    for arm in ("svm", "xgb"):
        assert got[arm] == want[arm], arm
    assert os.listdir(tmp_path / "t")
    # the per-key caps draw with default_rng(seed).permutation, as the JAX package does
    kw.update(features=("wpt",), pca_components=(2,))
    capped = tc.classical_main({"XX": {"metadata": meta, "flac": [flac]}}, sample_caps={}, default_cap=30,
                               device="cpu", cache_dir=str(tmp_path / "t2"), **kw)
    jcapped = jc.classical_main({"XX": {"metadata": meta, "flac": [flac]}}, sample_caps={}, default_cap=30,
                                cache_dir=str(tmp_path / "j2"), **kw)
    assert capped == jcapped and capped["n_test"] == 6


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the behaviour without a CUDA device")
def test_classical_main_on_cuda_raises_without_a_card(corpus):
    meta, flac = corpus
    with pytest.raises((RuntimeError, AssertionError)):
        tc.classical_main({"LA": {"metadata": meta, "flac": [flac]}}, seconds=1.0, features=("wpt",),
                          verbose=False)


def test_train_gridsearch_matches_jax():
    rng = np.random.default_rng(21)
    X = rng.standard_normal((90, 4))
    y = (X[:, 0] - X[:, 1] + 0.3 * rng.standard_normal(90) > 0).astype(int)
    grid = {"C": [0.1, 1], "kernel": ["rbf", "linear"], "gamma": ["scale"]}
    got = tc.train_gridsearch(X, y, param_grid=grid, device="cpu")
    want = jc.train_gridsearch(X, y, param_grid=grid)
    assert got.best_params_ == want.best_params_ and got.best_score_ == want.best_score_
    np.testing.assert_array_equal(got.cv_results_["mean_test_score"], want.cv_results_["mean_test_score"])
    Xq = rng.standard_normal((50, 4))
    sure = np.abs(want.best_estimator_.decision_function(Xq)) > 2e-3
    np.testing.assert_array_equal(got.predict(Xq)[sure], want.predict(Xq)[sure])


@pytest.mark.parametrize("cell", [None, 3.5, [1, 2], np.arange(6).reshape(2, 3), [[1, 2], [3]], [[1, [2, 3]], 4],
                                  (np.ones(2), np.zeros(3))])
def test_to_array_safe_matches_jax(cell):
    got, want = to_array_safe(cell), j_to_array_safe(cell)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_build_X_and_prepare_multi_match_jax(tmp_path):
    rng = np.random.default_rng(22)
    df = pd.DataFrame({"a": [rng.standard_normal(3) for _ in range(5)],
                       "b": [rng.standard_normal(2) for _ in range(4)] + [None],
                       "label": [0, 1, 0, 1, 1]})
    np.testing.assert_array_equal(build_X_from_df(_rows(df), ["a", "b"]), j_build_X(df, ["a", "b"]))
    np.testing.assert_array_equal(build_X_from_df(_rows(df[:4]), ["a", "b"]), j_build_X(df[:4], ["a", "b"]))
    assert build_X_from_df([], ["a"]).shape == j_build_X(df[:0], ["a"]).shape
    train = pd.DataFrame({"x": [rng.standard_normal((7, 4)).astype(np.float32) for _ in range(5)],
                          "z": [rng.standard_normal((3, 2)) for _ in range(5)]})
    test = pd.DataFrame({"x": [rng.standard_normal((2, 4)).astype(np.float32) for _ in range(3)],
                         "z": [rng.standard_normal((3, 2)) for _ in range(3)]})
    rows_tr, rows_te = _rows(train), _rows(test)
    tr, te, scalers = prepare_train_test_data_multi(rows_tr, rows_te, ["x", "z"], model_dir=str(tmp_path / "p"))
    jtr, jte, jscalers = j_prepare_multi(train, test, ["x", "z"], model_dir=str(tmp_path / "j"))
    for col in ("x", "z"):
        for got, want in ((tr, jtr), (te, jte)):
            for g, w in zip([r[col] for r in got], want[col]):
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(scalers[col].std, jscalers[col].std)
        with np.load(tmp_path / "p" / f"{col}_scaler.npz") as a, np.load(tmp_path / "j" / f"{col}_scaler.npz") as b:
            np.testing.assert_array_equal(a["mean"], b["mean"])
    assert rows_tr[0]["x"] is train["x"][0]  # the inputs stay as they were
