"""Splits and grid search: sklearn's ``model_selection`` without sklearn.

- ``train_test_split``: with ``stratify``, sklearn's ``StratifiedShuffleSplit``
  (``_approximate_mode`` for the per-class counts, then one permutation per
  class and one of each side, all from one ``RandomState``); without it,
  ``ShuffleSplit``'s single permutation. The indices are sklearn's, bitwise.
- ``StratifiedKFold``: ``_make_test_folds`` (classes coded by first
  appearance, round-robin allocation over the sorted codes, folds assigned
  in blocks, shuffled per class when ``shuffle``). Bitwise.
- ``ParameterGrid``: keys sorted, the last key varying fastest.
- ``GridSearchCV``: an integer ``cv`` is ``StratifiedKFold(cv)`` without
  shuffle; each candidate is a clone of the estimator with its parameters,
  fit on each fold's training rows and scored by accuracy on its test rows;
  the best candidate is the first with the top mean score (rank ``min``);
  it is refit on all the rows. A fit that raises scores NaN with a warning
  (sklearn's ``error_score=np.nan``), so its candidate ranks last; the
  search raises when every fit failed. The candidates run one after another on the
  estimator's device (``n_jobs`` is accepted).
"""

from __future__ import annotations

import warnings
from itertools import product
from math import ceil, floor

import numpy as np
import torch

from audioanalysisdetector_tpu_torch.ml._base import BaseEstimator, check_random_state, clone, labels_of
from audioanalysisdetector_tpu_torch.ml.metrics import accuracy_score


def _approximate_mode(class_counts: np.ndarray, n_draws: int, rng: np.random.RandomState) -> np.ndarray:
    """sklearn's ``utils.extmath._approximate_mode``."""
    continuous = class_counts / class_counts.sum() * n_draws
    floored = np.floor(continuous)
    need_to_add = int(n_draws - floored.sum())
    if need_to_add > 0:
        remainder = continuous - floored
        values = np.sort(np.unique(remainder))[::-1]
        for value in values:
            (inds,) = np.where(remainder == value)
            add_now = min(len(inds), need_to_add)
            inds = rng.choice(inds, size=add_now, replace=False)
            floored[inds] += 1
            need_to_add -= add_now
            if need_to_add == 0:
                break
    return floored.astype(int)


def _split_sizes(n_samples: int, test_size, train_size) -> tuple[int, int]:
    """``_validate_shuffle_split`` for float or int sizes (default test 0.25)."""
    if test_size is None and train_size is None:
        test_size = 0.25
    n_test = n_train = None
    if test_size is not None:
        n_test = ceil(test_size * n_samples) if isinstance(test_size, float) else int(test_size)
    if train_size is not None:
        n_train = floor(train_size * n_samples) if isinstance(train_size, float) else int(train_size)
    if n_train is None:
        n_train = n_samples - n_test
    elif n_test is None:
        n_test = n_samples - n_train
    if n_train + n_test > n_samples or n_train <= 0 or n_test <= 0:
        raise ValueError(f"train_size {n_train} and test_size {n_test} do not fit {n_samples} samples")
    return n_train, n_test


def stratified_shuffle_indices(y, n_train: int, n_test: int, random_state) -> tuple[np.ndarray, np.ndarray]:
    """One split of ``StratifiedShuffleSplit._iter_indices``."""
    classes, y_indices, class_counts = np.unique(labels_of(y), return_inverse=True, return_counts=True)
    if np.min(class_counts) < 2:
        raise ValueError("The least populated class in y has only 1 member, which is too few.")
    if n_train < len(classes) or n_test < len(classes):
        raise ValueError("each side of the split needs at least one row of every class")
    class_indices = np.split(np.argsort(y_indices, kind="stable"), np.cumsum(class_counts)[:-1])
    rng = check_random_state(random_state)
    n_i = _approximate_mode(class_counts, n_train, rng)
    t_i = _approximate_mode(class_counts - n_i, n_test, rng)
    train, test = [], []
    for i in range(len(classes)):
        perm = class_indices[i].take(rng.permutation(class_counts[i]), mode="clip")
        train.extend(perm[: n_i[i]])
        test.extend(perm[n_i[i]: n_i[i] + t_i[i]])
    return rng.permutation(train), rng.permutation(test)


def _take(a, idx: np.ndarray):
    if isinstance(a, torch.Tensor):
        return a[torch.as_tensor(idx, device=a.device)]
    if isinstance(a, np.ndarray):
        return a[idx]
    return [a[i] for i in idx]


def train_test_split(*arrays, test_size=None, train_size=None, random_state=None, shuffle: bool = True,
                     stratify=None) -> list:
    """sklearn's ``train_test_split`` over arrays, tensors or lists (rows of
    each taken by the same indices): ``[a_train, a_test, b_train, ...]``."""
    n_samples = len(arrays[0])
    n_train, n_test = _split_sizes(n_samples, test_size, train_size)
    if not shuffle:
        if stratify is not None:
            raise ValueError("Stratified train/test split is not implemented for shuffle=False")
        train, test = np.arange(n_train), np.arange(n_train, n_train + n_test)
    elif stratify is not None:
        train, test = stratified_shuffle_indices(stratify, n_train, n_test, random_state)
    else:
        perm = check_random_state(random_state).permutation(n_samples)
        test, train = perm[:n_test], perm[n_test: n_test + n_train]
    return [part for a in arrays for part in (_take(a, train), _take(a, test))]


class StratifiedKFold:
    """sklearn's ``StratifiedKFold`` (see the module docstring)."""

    def __init__(self, n_splits: int = 5, *, shuffle: bool = False, random_state=None):
        if not shuffle and random_state is not None:
            raise ValueError("Setting a random_state has no effect since shuffle is False.")
        self.n_splits, self.shuffle, self.random_state = n_splits, shuffle, random_state

    def _make_test_folds(self, y) -> np.ndarray:
        rng = check_random_state(self.random_state)
        y = labels_of(y)
        _, y_idx, y_inv = np.unique(y, return_index=True, return_inverse=True)
        _, class_perm = np.unique(y_idx, return_inverse=True)
        y_encoded = class_perm[y_inv]
        n_classes = len(y_idx)
        y_counts = np.bincount(y_encoded)
        if np.all(self.n_splits > y_counts):
            raise ValueError(f"n_splits={self.n_splits} cannot be greater than the number of members in each class.")
        y_order = np.sort(y_encoded)
        allocation = np.asarray([np.bincount(y_order[i:: self.n_splits], minlength=n_classes)
                                 for i in range(self.n_splits)])
        test_folds = np.empty(len(y), dtype="i")
        for k in range(n_classes):
            folds_for_class = np.arange(self.n_splits).repeat(allocation[:, k])
            if self.shuffle:
                rng.shuffle(folds_for_class)
            test_folds[y_encoded == k] = folds_for_class
        return test_folds

    def split(self, X, y, groups=None):
        test_folds = self._make_test_folds(y)
        indices = np.arange(len(test_folds))
        for i in range(self.n_splits):
            yield indices[test_folds != i], indices[test_folds == i]


class ParameterGrid:
    """Each dict's keys sorted, the product over their values (last key fastest)."""

    def __init__(self, param_grid):
        self.param_grid = [param_grid] if isinstance(param_grid, dict) else list(param_grid)

    def __iter__(self):
        for p in self.param_grid:
            items = sorted(p.items())
            if not items:
                yield {}
                continue
            keys, values = zip(*items)
            for v in product(*values):
                yield dict(zip(keys, v))

    def __len__(self) -> int:
        return sum(int(np.prod([len(v) for v in p.values()])) if p else 1 for p in self.param_grid)


class GridSearchCV(BaseEstimator):
    """sklearn's ``GridSearchCV`` with ``scoring="accuracy"`` (or None, the
    classifier's accuracy) and ``refit=True`` (see the module docstring)."""

    def __init__(self, estimator, param_grid, *, scoring="accuracy", n_jobs=None, cv=5):
        self.estimator = estimator
        self.param_grid = param_grid
        self.scoring = scoring
        self.n_jobs = n_jobs
        self.cv = cv

    def fit(self, X, y) -> "GridSearchCV":
        if self.scoring not in ("accuracy", None):
            raise ValueError(f"scoring={self.scoring!r}: the port's GridSearchCV scores by accuracy")
        y = labels_of(y)
        cv = StratifiedKFold(self.cv) if isinstance(self.cv, int) else self.cv
        folds = list(cv.split(X, y))
        Xd = X if isinstance(X, torch.Tensor) else np.asarray(X, dtype=np.float64)
        candidates = list(ParameterGrid(self.param_grid))
        scores = np.empty((len(candidates), len(folds)))
        errors = []
        for c, params in enumerate(candidates):
            for k, (train, test) in enumerate(folds):
                est = clone(self.estimator).set_params(**params)
                try:
                    est.fit(_take(Xd, train), y[train])
                except Exception as e:  # error_score=np.nan
                    scores[c, k] = np.nan
                    errors.append(f"{params}: {type(e).__name__}: {e}")
                    continue
                scores[c, k] = accuracy_score(y[test], est.predict(_take(Xd, test)))
        if len(errors) == scores.size:
            raise ValueError(f"All the {scores.size} fits failed: {errors[0]}")
        if errors:
            warnings.warn(f"{len(errors)} fits failed out of {scores.size}; their score is NaN: {errors[0]}")
        mean = np.average(scores, axis=1)
        std = np.sqrt(np.average((scores - mean[:, None]) ** 2, axis=1))
        # rank "min" (NaN below every score): 1 + the candidates scoring higher
        ranked = np.nan_to_num(mean, nan=np.nanmin(mean) - 1)
        rank = np.array([1 + int(np.sum(ranked > m)) for m in ranked], dtype=np.int32)
        self.cv_results_ = {"params": candidates, "mean_test_score": mean, "std_test_score": std,
                            "rank_test_score": rank,
                            **{f"split{k}_test_score": scores[:, k] for k in range(len(folds))}}
        for key in sorted({k for p in candidates for k in p}):
            self.cv_results_[f"param_{key}"] = [p.get(key) for p in candidates]
        self.best_index_ = int(np.argmin(rank))
        self.best_params_ = candidates[self.best_index_]
        self.best_score_ = float(mean[self.best_index_])
        self.best_estimator_ = clone(self.estimator).set_params(**self.best_params_)
        self.best_estimator_.fit(Xd, y)
        self.n_splits_ = len(folds)
        return self

    def predict(self, X) -> np.ndarray:
        return self.best_estimator_.predict(X)
