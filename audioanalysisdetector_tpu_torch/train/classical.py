"""Classical-ML bridge: feature expansion, preprocessing, grid searches (PyTorch port).

Counterpart of the JAX package's ``train/classical.py`` (the reference's
``expand_feature_columns``, reference/train_fun.py:227-246;
``preprocess_for_modeling``, :249-286; ``run_grid_search``, :289-302;
``main``, :305-403; ``run_extensive_gridsearch`` with its feature-set
generator and pipeline factory, reference/ASV_dl_func.py:1561-1758;
``train_gridsearch``, reference/xai_func.py:18-36), without pandas or
scikit-learn: tables are lists of row dicts, and the estimators are the
port's own (``ml/``), which compute on ``device`` (the card by default).

Quirks carried over from the pandas/sklearn code:

- ``expand_feature_columns`` ends with a frame-wide ``dropna()``: a row
  goes when any feature cell is null, when a vector is shorter than the
  column's widest (pandas pads it with NaN) or holds a NaN, or when a dict
  lacks a key another row has. Dict cells expand to ``{col}_{key}`` in the
  order of first appearance (``apply(pd.Series)``);
- ``preprocess_for_modeling`` lower-cases and maps the labels (anything
  else, ``"1"`` included, is dropped), splits 80/20 stratified with
  ``random_state=42``, oversamples the minority of the train split with
  ``default_rng(42).integers`` and fits the scaler on the balanced rows;
- ``run_extensive_gridsearch`` keeps pandas' row order for tied test
  scores: ``sort_values("test_score", ascending=False)`` reverses the rows,
  takes numpy's quicksort ``argsort`` and reverses again (``nargsort``),
  and the CSVs are written as pandas writes them.

The "XGB" arm: the port does not depend on xgboost, so ``_xgb_like``
always gives the port's ``HistGradientBoostingClassifier`` with
``_XGB_PARAM_MAP``: the JAX package's branch wherever xgboost is absent.
"""

from __future__ import annotations

import csv
import json
import os
import tempfile
from typing import Iterator

import numpy as np
import torch

from audioanalysisdetector_tpu_torch.data.balance import is_null
from audioanalysisdetector_tpu_torch.ml import (
    PCA,
    SVC,
    FastICA,
    FitCache,
    GridSearchCV,
    HistGradientBoostingClassifier,
    Pipeline,
    StandardScaler,
    StratifiedKFold,
    accuracy_score,
    classification_report,
    f1_score,
    train_test_split,
)

LABEL_MAP = {"spoof": 1, "bonafide": 0}  # reference/train_fun.py:255


def _nan(v) -> bool:
    return is_null(v) or (isinstance(v, (float, np.floating)) and np.isnan(v))


def expand_feature_columns(rows: list[dict], feature_columns: list[str], label_column: str) -> list[dict]:
    """Explode vector/dict feature cells into scalar columns: new rows of
    ``{col}_{i}`` / ``{col}_{key}`` floats and the label, in the order of
    ``rows`` (see the module docstring for the rows that are dropped)."""
    n = len(rows)
    columns: list[list[str]] = []
    values: list[list[list[float] | None]] = []
    for col in feature_columns:
        kept = [i for i in range(n) if not is_null(rows[i][col])]
        if not kept:
            raise ValueError(
                f"feature column {col!r} has no non-null cells — its "
                "extractor failed for every row (check the per-file warnings)"
            )
        cells: list[list[float] | None] = [None] * n
        if isinstance(rows[kept[0]][col], dict):
            keys: list = []
            for i in kept:
                keys.extend(k for k in rows[i][col] if k not in keys)
            for i in kept:
                cell = rows[i][col]
                cells[i] = [float(cell[k]) if k in cell and not is_null(cell[k]) else np.nan for k in keys]
            names = [f"{col}_{k}" for k in keys]
        else:
            flat = {i: np.ravel(np.asarray(rows[i][col])).astype(np.float64) for i in kept}
            width = max(v.size for v in flat.values())
            for i, v in flat.items():
                cells[i] = list(v) + [np.nan] * (width - v.size)
            names = [f"{col}_{k}" for k in range(width)]
        columns.append(names)
        values.append(cells)
    out = []
    for i, row in enumerate(rows):
        label = row[label_column]
        if any(v[i] is None or any(np.isnan(x) for x in v[i]) for v in values) or _nan(label):
            continue
        new = {name: x for names, v in zip(columns, values) for name, x in zip(names, v[i])}
        new[label_column] = label
        out.append(new)
    return out


def _matrix(rows: list[dict], cols: list[str]) -> np.ndarray:
    return np.array([[r[c] for c in cols] for r in rows], dtype=np.float64).reshape(len(rows), len(cols))


def preprocess_for_modeling(rows: list[dict], label_col: str = "label", *, device: str | torch.device = "cuda"):
    """Label map {spoof:1, bonafide:0}, stratified split, train-only
    oversampling, StandardScaler (the reference's exact order). Returns
    ``(X_train, X_test, y_train, y_test, scaler)``, numpy arrays."""
    kept = []
    for r in rows:
        code = LABEL_MAP.get(str(r[label_col]).lower())
        if code is not None:
            kept.append((r, code))
    cols = [c for c in (rows[0] if rows else {}) if c != label_col]
    X = _matrix([r for r, _ in kept], cols)
    y = np.array([c for _, c in kept], dtype=np.int64)
    X_train, X_test, y_train, y_test = train_test_split(X, y, test_size=0.2, stratify=y, random_state=42)
    c0, c1 = X_train[y_train == 0], X_train[y_train == 1]
    if len(c0) == 0 or len(c1) == 0:
        raise ValueError("training split lacks one of the classes; cannot oversample")
    rng = np.random.default_rng(42)
    if len(c0) > len(c1):
        c1 = c1[rng.integers(0, len(c1), len(c0))]
    else:
        c0 = c0[rng.integers(0, len(c0), len(c1))]
    balanced = np.concatenate([c0, c1])
    y_balanced = np.concatenate([np.zeros(len(c0), np.int64), np.ones(len(c1), np.int64)])
    scaler = StandardScaler(device=device)
    X_train_scaled = scaler.fit_transform(balanced)
    X_test_scaled = scaler.transform(X_test)
    return X_train_scaled, X_test_scaled, y_balanced, y_test, scaler


def run_grid_search(grid: GridSearchCV, X_train, y_train, X_test, y_test):
    grid.fit(X_train, y_train)
    best = grid.best_estimator_
    y_pred = best.predict(X_test)
    return grid, accuracy_score(y_test, y_pred), f1_score(y_test, y_pred)


def generate_feature_sets(feature_cols: list[str]) -> Iterator[tuple[str, list[str]]]:
    """all / singletons / ordered pairs (reference/ASV_dl_func.py:1561-1572)."""
    yield ("all", list(feature_cols))
    for c in feature_cols:
        yield (c, [c])
    for c in feature_cols:
        for other in feature_cols:
            if other != c:
                yield (f"{c}_plus_{other}", [c, other])


def _xgb_like(random_state: int, *, device: str | torch.device = "cuda"):
    """The "XGB" arm: the port's HistGradientBoostingClassifier and the
    parameter map (the JAX package's branch wherever xgboost is absent;
    the port does not depend on xgboost)."""
    return HistGradientBoostingClassifier(random_state=random_state, device=device), _XGB_PARAM_MAP


# xgboost -> HistGradientBoosting hyperparameter role mapping
_XGB_PARAM_MAP = {
    "clf__n_estimators": "clf__max_iter",
    "clf__max_depth": "clf__max_depth",
    "clf__learning_rate": "clf__learning_rate",
    # subsample / colsample / gamma have no HGB equivalent: dropped
}

# the reference's full 6-key default XGB grid (reference/ASV_dl_func.py:1613-1619);
# the HGB arm keeps the 3 keys _XGB_PARAM_MAP can express
DEFAULT_XGB_PARAMS = {
    "clf__n_estimators": [50, 100],
    "clf__max_depth": [3, 5],
    "clf__learning_rate": [0.1, 0.05],
    "clf__subsample": [0.8, 1],
    "clf__colsample_bytree": [0.8, 1],
    "clf__gamma": [0, 1],
}


def make_search_pipeline(
    reducer: str | None, n_comp: int | None, standardize: bool, classifier,
    *, memory: FitCache | str | None = None, device: str | torch.device = "cuda",
) -> Pipeline:
    """``memory``: a ``FitCache`` (or its directory): identical (scaler,
    reducer) prefixes are then fit once across the whole sweep (the
    reference's ``joblib.Memory`` trick, reference/train_fun.py:364-370)."""
    steps = []
    if standardize:
        steps.append(("scaler", StandardScaler(device=device)))
    if reducer == "pca" and n_comp is not None:
        steps.append(("reducer", PCA(n_components=n_comp, random_state=42, device=device)))
    elif reducer == "ica" and n_comp is not None:
        steps.append(("reducer", FastICA(n_components=n_comp, random_state=42, device=device)))
    steps.append(("clf", classifier))
    return Pipeline(steps, memory=memory)


SUMMARY_COLUMNS = ("model", "feature_set", "std", "reducer", "n_comp", "train_score", "test_score",
                   "precision", "recall", "f1", "best_params")


def _sorted_by_test_score(results: list[dict]) -> list[dict]:
    """pandas' ``sort_values("test_score", ascending=False)`` (``nargsort``)."""
    scores = np.array([r["test_score"] for r in results], dtype=np.float64)
    idx = np.arange(len(scores))[::-1]
    indexer = idx[scores[::-1].argsort(kind="quicksort")][::-1]
    return [results[i] for i in indexer]


def _write_csv(path: str, rows: list[dict], all_rows: list[dict]) -> None:
    """Rows as pandas' ``to_csv(index=False)`` writes them: ``None`` empty,
    a column mixing ints and ``None`` as floats, floats in repr."""
    float_cols = {c for c in SUMMARY_COLUMNS
                  if any(r[c] is None for r in all_rows)
                  and any(isinstance(r[c], (int, np.integer)) and not isinstance(r[c], bool) for r in all_rows)}

    def cell(col, v):
        if v is None:
            return ""
        if col in float_cols:
            return repr(float(v))
        if isinstance(v, (float, np.floating)):
            return repr(float(v))
        return str(v)

    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(SUMMARY_COLUMNS)
        for r in rows:
            w.writerow([cell(c, r[c]) for c in SUMMARY_COLUMNS])


def run_extensive_gridsearch(
    df_train: list[dict],
    df_test: list[dict],
    feature_cols: list[str] | None = None,
    *,
    feature_groups: dict[str, list[str]] | None = None,
    svm_params: dict | None = None,
    xgb_params: dict | None = None,
    cv: int = 3,
    scoring: str = "accuracy",
    n_jobs: int = -1,
    min_samples: int = 10,
    top_k: int = 5,
    label_col: str = "label",
    out_dir: str = "gridsearch_results",
    components: tuple[int, ...] = (10, 20, 30, 40),
    random_state: int = 42,
    cache_dir: str | None = None,
    device: str | torch.device = "cuda",
):
    """Sweep feature sets x {std} x {None, PCA, ICA} x components x {SVM, XGB};
    write ``gridsearch_summary.csv`` and ``top_{top_k}_models.csv`` (the
    reference's exact search space and defaults). Returns ``(top rows, all
    rows)`` sorted by test score, or ``(None, None)`` when nothing fit.

    ``cache_dir`` turns on the pipeline cache: every (scaler, reducer)
    prefix is fit once per feature set and fold instead of once per
    classifier x param combo (reference/train_fun.py:364-370)."""
    memory = FitCache(cache_dir) if cache_dir is not None else None
    if svm_params is None:
        svm_params = {"clf__C": [1, 10], "clf__kernel": ["rbf"], "clf__gamma": ["scale", 0.1]}
    if xgb_params is None:
        xgb_params = DEFAULT_XGB_PARAMS
    os.makedirs(out_dir, exist_ok=True)
    y_train = np.array([r[label_col] for r in df_train])
    y_test = np.array([r[label_col] for r in df_test])
    results = []

    if feature_groups:
        # the reference's sweep shape: all / singletons / ordered pairs of
        # BASE features, each mapped to its expanded scalar columns
        feature_sets = [
            (name, [c for g in groups for c in feature_groups[g]])
            for name, groups in generate_feature_sets(list(feature_groups))
        ]
    elif feature_cols is None:
        feature_sets = [("all_features", [c for c in (df_train[0] if df_train else {}) if c != label_col])]
    else:
        feature_sets = [("selected_features", feature_cols)]
    for fs_name, fs_cols in feature_sets:
        X_train = _matrix(df_train, fs_cols)
        X_test = _matrix(df_test, fs_cols)
        if X_train.shape[0] < min_samples:
            continue
        n_features = X_train.shape[1]
        for standardize in (False, True):
            for reducer in (None, "pca", "ica"):
                comp_list = components if reducer else (None,)
                for n_comp in comp_list:
                    if n_comp is not None and n_comp >= n_features:
                        continue
                    arms = [("SVM", SVC(probability=True, random_state=random_state, device=device), svm_params)]
                    xgb, param_map = _xgb_like(random_state, device=device)
                    params = {param_map[k]: v for k, v in xgb_params.items() if k in param_map}
                    arms.append(("XGB", xgb, params))
                    for model_name, clf, param_grid in arms:
                        pipe = make_search_pipeline(reducer, n_comp, standardize, clf, memory=memory, device=device)
                        try:
                            gs = GridSearchCV(
                                pipe,
                                param_grid,
                                cv=StratifiedKFold(cv, shuffle=True, random_state=random_state),
                                scoring=scoring,
                                n_jobs=n_jobs,
                            )
                            gs.fit(X_train, y_train)
                            y_pred = gs.predict(X_test)
                            rep = classification_report(y_test, y_pred, output_dict=True)
                        except Exception as e:  # per-combo failures are skipped
                            print(f"  {model_name} failed (std={standardize}, "
                                  f"reducer={reducer}, n_comp={n_comp}): {e}")
                            continue
                        results.append({
                            "model": model_name,
                            "feature_set": fs_name,
                            "std": standardize,
                            "reducer": reducer,
                            "n_comp": n_comp,
                            "train_score": gs.best_score_,
                            "test_score": accuracy_score(y_test, y_pred),
                            "precision": rep["weighted avg"]["precision"],
                            "recall": rep["weighted avg"]["recall"],
                            "f1": rep["weighted avg"]["f1-score"],
                            "best_params": json.dumps(gs.best_params_, default=str),
                        })

    if not results:
        print("no grid-search results to save")
        return None, None
    ordered = _sorted_by_test_score(results)
    top = ordered[:top_k]
    _write_csv(os.path.join(out_dir, "gridsearch_summary.csv"), ordered, results)
    _write_csv(os.path.join(out_dir, f"top_{top_k}_models.csv"), top, results)
    return top, ordered


CLASSICAL_FEATURES = ("mfcc", "lfcc", "cqcc", "gtcc", "wpt", "formants")


def classical_main(
    all_data: dict[str, dict],
    *,
    sr: int = 16000,
    seconds: float = 4.0,
    sample_caps: dict[str, int] | None = None,
    default_cap: int = 2500,
    features: tuple[str, ...] = CLASSICAL_FEATURES,
    pca_components: tuple[int, ...] = (10, 20, 30, 40),
    svm_c: tuple[int, ...] = (1, 10),
    n_estimators: tuple[int, ...] = (50, 100),
    max_depth: tuple[int, ...] = (3, 5),
    cv: int = 3,
    cache_dir: str | None = None,
    extension: str = ".flac",
    seed: int = 42,
    verbose: bool = True,
    device: str | torch.device = "cuda",
) -> dict:
    """The reference's classical end-to-end ``main()``
    (reference/train_fun.py:305-403), metadata-driven:

    per-dataset metadata -> existing-file resolution -> sample caps
    (LA 5000 / others 2500, :321-331, drawn with ``default_rng(seed)``) ->
    batched extraction of the 6 features incl. the formant/silence dict
    (:334-344) on ``device`` -> dropna -> ``expand_feature_columns`` ->
    ``preprocess_for_modeling`` -> PCA+SVC and PCA+XGB ``GridSearchCV``
    (cv=3, accuracy) with the pipeline cache (:364-370) under
    ``cache_dir``, both on ``device``.

    As in the JAX package, features are computed over a fixed ``seconds``
    analysis window (zero-padded when shorter) where the reference reads
    whole files; time-mean pooling makes the two near-identical for
    speech-length audio.

    Returns {"svm": {...}, "xgb": {...}, "n_train": int, "n_test": int}.
    """
    from audioanalysisdetector_tpu_torch.data.metadata import prepare_filepaths, read_metadata
    from audioanalysisdetector_tpu_torch.data.pipeline import extract_features

    sample_caps = sample_caps if sample_caps is not None else {"LA": 5000}
    rng = np.random.default_rng(seed)

    tables = []
    for key, value in all_data.items():
        folders = value["flac"]
        if isinstance(folders, str):
            folders = [folders]
        for folder in folders:
            try:
                rows = read_metadata(value["metadata"])
            except FileNotFoundError:
                print(f"WARNING: metadata file not found: {value['metadata']}")
                continue
            rows = prepare_filepaths(rows, folder, extension=extension)
            if verbose:
                print(f"found {len(rows)} existing files for {key} in {os.path.basename(folder)}")
            if not rows:
                continue
            cap = sample_caps.get(key, default_cap)
            if len(rows) > cap:
                rows = [rows[i] for i in rng.permutation(len(rows))[:cap]]
            tables.append(rows)
    if not tables:
        raise ValueError("no usable data from any configured dataset")
    # pandas' concat(join="inner"): the columns every table has, in the first's order
    common = [c for c in tables[0][0] if all(c in t[0] for t in tables)]
    final = [{c: r[c] for c in common} for t in tables for r in t]
    if verbose:
        print(f"total files to process: {len(final)}")

    # fixed analysis window; mean-pooled like the reference's whole-file
    # extractors (reference/train_fun.py:69-141 all return means)
    for r in final:
        r["chunk_start"], r["chunk_end"] = 0.0, float(seconds)
    final = extract_features(final, list(features), sr=sr, mean=True, device=device)

    initial = len(final)
    final = [r for r in final if not any(is_null(r[f]) for f in features)]
    if verbose:
        print(f"dropped {initial - len(final)} rows with extraction failures")
    if not final:
        raise ValueError("no valid rows after feature extraction")

    expanded = expand_feature_columns(final, list(features), "label")
    X_train, X_test, y_train, y_test, _ = preprocess_for_modeling(expanded, device=device)
    if verbose:
        print(f"train (balanced): {X_train.shape}  test: {X_test.shape}")

    cache_dir = cache_dir or os.path.join(tempfile.gettempdir(), "aad_classical_torch_cache")
    common = dict(pca_components=pca_components, cv=cv, cache_dir=cache_dir, seed=seed, device=device)
    return {
        "n_train": int(len(y_train)), "n_test": int(len(y_test)),
        "svm": svm_grid(X_train, y_train, X_test, y_test, svm_c=svm_c, **common),
        "xgb": xgb_grid(X_train, y_train, X_test, y_test, n_estimators=n_estimators, max_depth=max_depth, **common),
    }


def _pca_pipeline(clf, X_train, pca_components, cache_dir, seed, device):
    """``Pipeline([("pca", PCA), ("clf", clf)])`` cached under ``cache_dir``
    (the cache fits each (fold, n_components) PCA once across the classifier
    candidates, reference/train_fun.py:364-370), and the PCA widths the
    rows allow."""
    memory = FitCache(cache_dir) if cache_dir is not None else None
    comps = [c for c in pca_components if c < X_train.shape[1]] or [max(X_train.shape[1] - 1, 1)]
    pipe = Pipeline([("pca", PCA(random_state=seed, device=device)), ("clf", clf)], memory=memory)
    return pipe, comps


def _scored(grid, X_train, y_train, X_test, y_test) -> dict:
    _, acc, f1 = run_grid_search(grid, X_train, y_train, X_test, y_test)
    return {"accuracy": acc, "f1": f1, "best_params": {k: str(v) for k, v in grid.best_params_.items()}}


def svm_grid(
    X_train, y_train, X_test, y_test,
    *,
    pca_components: tuple[int, ...] = (10, 20, 30, 40),
    svm_c: tuple[int, ...] = (1, 10),
    cv: int = 3,
    cache_dir: str | None = None,
    seed: int = 42,
    device: str | torch.device = "cuda",
) -> dict:
    """``classical_main``'s PCA + SVC ``GridSearchCV`` (``cv`` folds,
    accuracy) on prepared rows, scored on the test rows: ``{"accuracy",
    "f1", "best_params"}``."""
    pipe, comps = _pca_pipeline(SVC(probability=True, random_state=seed, device=device),
                                X_train, pca_components, cache_dir, seed, device)
    params = {"pca__n_components": comps, "clf__C": list(svm_c), "clf__kernel": ["rbf"], "clf__gamma": ["scale"]}
    grid = GridSearchCV(pipe, params, scoring="accuracy", cv=cv, n_jobs=-1)
    return _scored(grid, X_train, y_train, X_test, y_test)


def xgb_grid(
    X_train, y_train, X_test, y_test,
    *,
    pca_components: tuple[int, ...] = (10, 20, 30, 40),
    n_estimators: tuple[int, ...] = (50, 100),
    max_depth: tuple[int, ...] = (3, 5),
    cv: int = 3,
    cache_dir: str | None = None,
    seed: int = 42,
    device: str | torch.device = "cuda",
) -> dict:
    """``classical_main``'s PCA + XGB-arm ``GridSearchCV`` (``_xgb_like``,
    ``cv`` folds, accuracy) on prepared rows, scored on the test rows:
    ``{"accuracy", "f1", "best_params"}``."""
    xgb, param_map = _xgb_like(seed, device=device)
    pipe, comps = _pca_pipeline(xgb, X_train, pca_components, cache_dir, seed, device)
    params = {
        "pca__n_components": comps,
        "clf__n_estimators": list(n_estimators),
        "clf__max_depth": list(max_depth),
        "clf__learning_rate": [0.1],
    }
    params = {param_map.get(k, k): v for k, v in params.items() if not k.startswith("clf__") or k in param_map}
    grid = GridSearchCV(pipe, params, scoring="accuracy", cv=cv, n_jobs=-1)
    return _scored(grid, X_train, y_train, X_test, y_test)


def train_gridsearch(X_train, y_train, *, param_grid=None, cv: int = 3, device: str | torch.device = "cuda"):
    """Small SVC grid search (the reference's ``train_gridsearch``,
    reference/xai_func.py:18-36): returns the fitted GridSearchCV."""
    if param_grid is None:
        param_grid = {"C": [0.1, 1, 10], "kernel": ["rbf", "linear"], "gamma": ["scale"]}
    grid = GridSearchCV(SVC(probability=True, random_state=42, device=device), param_grid, cv=cv)
    grid.fit(X_train, y_train)
    return grid
