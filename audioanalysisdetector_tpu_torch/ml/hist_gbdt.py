"""``HistGradientBoostingClassifier`` (binary, log-loss) with its trees grown on the device.

sklearn 1.9's algorithm (``ensemble/_hist_gradient_boosting``), part by part:

- binning (``binning.py``): per feature, thresholds at the midpoints of the
  distinct values, or ``np.percentile(..., method="averaged_inverted_cdf")``
  past ``max_bins`` (255) of them, on the host in numpy as sklearn computes
  them (bitwise), after a subsample of 2e5 rows only above 2e5 rows; a value
  goes to the first bin whose threshold is >= it (``torch.searchsorted``);
- the loss (``_loss.pyx``, ``HalfBinomialLoss``): the baseline
  ``log(p / (1 - p))`` of the clipped mean label; gradients and hessians
  computed in float64 with ``cgrad_hess_half_binomial``'s branches and
  stored in float32;
- the grower (``grower.py``, ``splitting.pyx``): best-first growth from a
  heap ordered by gain, ``max_leaf_nodes=31``, ``min_samples_leaf=20``,
  ``min_hessian_to_split=1e-3``, ``l2_regularization=0``; histograms are
  float64 sums over (feature, bin) built on the device with ``index_add_``
  for the smaller child and by subtraction for the larger; the split search
  is a cumulative sum over the bins and one ``argmax`` over (feature, bin),
  so ties go to the first feature, then the first bin, as sklearn's strict
  ``>`` scans; leaf values ``-G / (H + l2 + 1e-15)`` times ``learning_rate``;
- ``early_stopping="auto"`` (``gradient_boosting.py``): above 10,000 rows a
  stratified 10% validation split through ``ml.model_selection.
  train_test_split``, seeded from ``RandomState(random_state)`` as sklearn
  seeds it, stopping when the last ``n_iter_no_change=10`` validation
  losses do not beat the one before them by ``tol=1e-7``.

The host reads one small tensor per split (the best split of both children),
to keep the heap. Missing values (NaN) are not supported: the classical
path drops such rows before it fits.
"""

from __future__ import annotations

import heapq

import numpy as np
import torch
from numpy.lib.stride_tricks import sliding_window_view

from audioanalysisdetector_tpu_torch.ml._base import (
    BaseEstimator,
    as_tensor,
    check_random_state,
    labels_of,
    to_numpy,
)
from audioanalysisdetector_tpu_torch.ml.model_selection import train_test_split

ALMOST_INF = 1e300
N_BINS = 256  # 255 value bins and sklearn's bin for missing values
SUBSAMPLE = int(2e5)
MIN_HESSIAN_TO_SPLIT = 1e-3


def find_binning_thresholds(col_data: np.ndarray, max_bins: int) -> np.ndarray:
    """sklearn's ``_find_binning_thresholds`` for one column without NaN or
    sample weights (host numpy, bitwise)."""
    col_data = col_data[np.argsort(col_data)]
    distinct_values = np.unique(col_data).astype(np.float64)
    if len(distinct_values) == 1:
        return np.asarray([])
    if len(distinct_values) <= max_bins:
        bin_thresholds = sliding_window_view(distinct_values, 2).mean(axis=1)
    else:
        percentiles = np.linspace(0, 100, num=max_bins + 1)[1:-1]
        bin_thresholds = np.percentile(col_data, percentiles, method="averaged_inverted_cdf")
    unique_bin_values = np.unique(bin_thresholds)
    if unique_bin_values.shape[0] != bin_thresholds.shape[0]:
        bin_thresholds = unique_bin_values
    np.clip(bin_thresholds, a_min=None, a_max=ALMOST_INF, out=bin_thresholds)
    return bin_thresholds


def _log1pexp(x: torch.Tensor) -> torch.Tensor:
    """``_loss.pyx::log1pexp``'s branches."""
    return torch.where(x <= -37, torch.exp(x), torch.where(
        x <= -2, torch.log1p(torch.exp(x)), torch.where(
            x <= 18, torch.log(1.0 + torch.exp(x)), torch.where(x <= 33.3, x + torch.exp(-x), x))))


def half_binomial_loss(y: torch.Tensor, raw: torch.Tensor) -> float:
    """The mean ``log1pexp(raw) - y raw`` (sklearn's loss for early stopping)."""
    return float((_log1pexp(raw) - y * raw).mean())


def gradient_hessian(y: torch.Tensor, raw: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``cgrad_hess_half_binomial`` in float64, stored in float32 (sklearn's
    ``G_H_DTYPE``), returned as float64 for the histogram sums."""
    big = raw > -37
    e = torch.exp(torch.where(big, -raw, raw))
    g = torch.where(big, ((1 - y) - y * e) / (1 + e), e - y)
    h = torch.where(big, e / (1 + e) ** 2, e)
    return g.float().double(), h.float().double()


class _Node:
    """A grower node; ``__lt__`` orders the heap by gain, as sklearn's."""

    __slots__ = ("depth", "idx", "n", "G", "H", "value", "split", "left", "right", "is_leaf", "hist")

    def __init__(self, depth, idx, n, G, H, value):
        self.depth, self.idx, self.n, self.G, self.H, self.value = depth, idx, n, G, H, value
        self.split = None  # (gain, feature, bin, GL, HL, nL, value_left, value_right)
        self.left = self.right = self.hist = None
        self.is_leaf = False

    def __lt__(self, other: "_Node") -> bool:
        return self.split[0] > other.split[0]


class _TreeGrower:
    """sklearn's ``TreeGrower`` over binned data on the device."""

    def __init__(self, flat: torch.Tensor, Xb: torch.Tensor, gh: torch.Tensor, end: torch.Tensor, *,
                 max_leaf_nodes, max_depth, min_samples_leaf, l2_regularization, shrinkage):
        self.flat, self.Xb, self.gh, self.end = flat, Xb, gh, end
        self.n_features = Xb.shape[1]
        self.max_leaf_nodes, self.max_depth = max_leaf_nodes, max_depth
        self.min_samples_leaf, self.l2, self.shrinkage = min_samples_leaf, float(l2_regularization), shrinkage
        self.bins = torch.arange(N_BINS, device=Xb.device)
        self.splittable: list[_Node] = []
        self.leaves: list[_Node] = []
        self.n_splits = 0
        n = Xb.shape[0]
        self.root = _Node(0, torch.arange(n, device=Xb.device), n, 0.0, 0.0, 0.0)
        if n < 2 * min_samples_leaf:  # a leaf of value 0 whatever its sums
            self._finalize(self.root)
            return
        hist = self._histogram(self.root.idx)
        sums = hist[0].sum(0)
        self.root.G, self.root.H = float(sums[0]), float(sums[1])
        if self.root.H < MIN_HESSIAN_TO_SPLIT:
            self._finalize(self.root)
            return
        self.root.hist = hist
        self._find_splits_and_push([self.root])

    def _histogram(self, idx: torch.Tensor) -> torch.Tensor:
        """(features, bins, 3) sums of gradient, hessian and count over the rows ``idx``."""
        rows = self.flat.index_select(0, idx).reshape(-1)
        vals = self.gh.index_select(0, idx)[:, None, :].expand(-1, self.n_features, -1).reshape(-1, 3)
        out = torch.zeros(self.n_features * N_BINS, 3, dtype=torch.float64, device=idx.device)
        return out.index_add_(0, rows, vals).view(self.n_features, N_BINS, 3)

    def _find_splits_and_push(self, nodes: list[_Node]) -> None:
        """``find_node_split`` for each node (one batch on the device, one read)."""
        hist = torch.stack([nd.hist for nd in nodes])
        tot = torch.tensor([[nd.G, nd.H, nd.n, nd.value] for nd in nodes], dtype=torch.float64,
                           device=hist.device)
        G, H, n, value = (tot[:, k, None, None] for k in range(4))
        cum = hist.cumsum(2)
        GL, HL, NL = cum[..., 0], cum[..., 1], cum[..., 2]
        GR, HR, NR = G - GL, H - HL, n - NL
        msl = self.min_samples_leaf
        valid = ((self.bins[None, None, :] < self.end[None, :, None]) & (NL >= msl) & (NR >= msl)
                 & (HL >= MIN_HESSIAN_TO_SPLIT) & (HR >= MIN_HESSIAN_TO_SPLIT))
        vL = -GL / (HL + self.l2 + 1e-15)
        vR = -GR / (HR + self.l2 + 1e-15)
        gain = G * value - GL * vL - GR * vR
        gain = torch.where(valid & (gain > 0), gain, -1.0).flatten(1)
        best = torch.argmax(gain, dim=1)
        pick = lambda t: t.flatten(1).gather(1, best[:, None])[:, 0]  # noqa: E731
        out = torch.stack([gain.gather(1, best[:, None])[:, 0], best.double(), pick(GL), pick(HL), pick(NL),
                           pick(vL), pick(vR)], dim=1).cpu().numpy()
        for nd, (g, flat_best, gl, hl, nl, v_l, v_r) in zip(nodes, out):
            if g <= 0:
                self._finalize(nd)
                continue
            f, b = divmod(int(flat_best), N_BINS)
            nd.split = (g, f, b, gl, hl, int(nl), v_l, v_r)
            heapq.heappush(self.splittable, nd)

    def _finalize(self, node: _Node) -> None:
        node.is_leaf = True
        node.hist = None
        self.leaves.append(node)

    def grow(self) -> None:
        while self.splittable:
            self._split_next()
        for leaf in self.leaves:
            leaf.value *= self.shrinkage

    def _split_next(self) -> None:
        node = heapq.heappop(self.splittable)
        gain, f, b, gl, hl, nl, v_l, v_r = node.split
        # a stable partition of the node's rows, sized by the split's counts
        # (no read of the mask back to the host)
        goes_right = (self.Xb[:, f].index_select(0, node.idx) > b).to(torch.uint8)
        idx = node.idx.index_select(0, torch.argsort(goes_right, stable=True))
        depth = node.depth + 1
        left = _Node(depth, idx[:nl], nl, gl, hl, v_l)
        right = _Node(depth, idx[nl:], node.n - nl, node.G - gl, node.H - hl, v_r)
        node.left, node.right = left, right
        self.n_splits += 1
        n_leaf_nodes = len(self.leaves) + len(self.splittable) + 2
        if self.max_leaf_nodes is not None and n_leaf_nodes == self.max_leaf_nodes:
            self._finalize(left)
            self._finalize(right)
            while self.splittable:
                self._finalize(self.splittable.pop())
            node.hist = None
            return
        if self.max_depth is not None and depth == self.max_depth:
            self._finalize(left)
            self._finalize(right)
            node.hist = None
            return
        for child in (left, right):
            if child.n < 2 * self.min_samples_leaf:
                self._finalize(child)
        if not (left.is_leaf and right.is_leaf):
            small, large = (left, right) if left.n < right.n else (right, left)
            small.hist = self._histogram(small.idx)
            large.hist = node.hist - small.hist
            self._find_splits_and_push([c for c in (left, right) if not c.is_leaf])
        node.hist = None

    def predictor(self, thresholds: list[np.ndarray]) -> dict:
        """The tree in sklearn's depth-first node order (``_fill_predictor_arrays``)."""
        feat, bin_thr, num_thr, left, right, leaf, value = [], [], [], [], [], [], []

        def fill(nd: _Node) -> int:
            k = len(feat)
            feat.append(0), bin_thr.append(0), num_thr.append(0.0), left.append(0), right.append(0)
            leaf.append(nd.is_leaf), value.append(nd.value)
            if not nd.is_leaf:
                _, f, b = nd.split[:3]
                feat[k], bin_thr[k], num_thr[k] = f, b, thresholds[f][b]
                left[k] = fill(nd.left)
                right[k] = fill(nd.right)
            return k

        fill(self.root)
        return {"feature_idx": np.array(feat, np.int64), "bin_threshold": np.array(bin_thr, np.int64),
                "num_threshold": np.array(num_thr, np.float64), "left": np.array(left, np.int64),
                "right": np.array(right, np.int64), "is_leaf": np.array(leaf, bool),
                "value": np.array(value, np.float64)}

    def leaf_increments(self, n: int, device) -> torch.Tensor:
        """Each training row's leaf value (the leaves partition the rows)."""
        inc = torch.zeros(n, dtype=torch.float64, device=device)
        idx = torch.cat([lf.idx for lf in self.leaves])
        vals = torch.cat([torch.full((lf.n,), lf.value, dtype=torch.float64, device=device) for lf in self.leaves])
        return inc.index_copy_(0, idx, vals)


def _stack_trees(trees: list[dict], device) -> dict:
    """The trees' node arrays padded to one (n_trees, max_nodes) tensor each."""
    width = max(len(t["value"]) for t in trees)
    out = {}
    for key in ("feature_idx", "bin_threshold", "num_threshold", "left", "right", "is_leaf", "value"):
        arr = np.zeros((len(trees), width), dtype=trees[0][key].dtype)
        for k, t in enumerate(trees):
            arr[k, : len(t[key])] = t[key]
        out[key] = torch.as_tensor(arr, device=device)
    return out


def _tree_values(stacked: dict, X: torch.Tensor, binned: bool) -> torch.Tensor:
    """(n_trees, rows) leaf values of each tree for each row of ``X``: left
    where ``x <= num_threshold`` (or ``bin <= bin_threshold`` on binned data)."""
    n_trees = stacked["value"].shape[0]
    node = torch.zeros(n_trees, X.shape[0], dtype=torch.int64, device=X.device)
    XT = X.T.contiguous()
    thr = stacked["bin_threshold"] if binned else stacked["num_threshold"]
    while True:
        is_leaf = stacked["is_leaf"].gather(1, node)
        if bool(is_leaf.all()):
            break
        f = stacked["feature_idx"].gather(1, node)
        go_left = XT.gather(0, f) <= thr.gather(1, node)
        nxt = torch.where(go_left, stacked["left"].gather(1, node), stacked["right"].gather(1, node))
        node = torch.where(is_leaf, node, nxt)
    return stacked["value"].gather(1, node)


class HistGradientBoostingClassifier(BaseEstimator):
    """Binary gradient-boosted trees (see the module docstring)."""

    def __init__(self, *, loss: str = "log_loss", learning_rate: float = 0.1, max_iter: int = 100,
                 max_leaf_nodes: int | None = 31, max_depth: int | None = None, min_samples_leaf: int = 20,
                 l2_regularization: float = 0.0, max_bins: int = 255, early_stopping="auto",
                 scoring: str = "loss", validation_fraction: float = 0.1, n_iter_no_change: int = 10,
                 tol: float = 1e-7, random_state=None, device: str | torch.device = "cuda"):
        self.loss = loss
        self.learning_rate = learning_rate
        self.max_iter = max_iter
        self.max_leaf_nodes = max_leaf_nodes
        self.max_depth = max_depth
        self.min_samples_leaf = min_samples_leaf
        self.l2_regularization = l2_regularization
        self.max_bins = max_bins
        self.early_stopping = early_stopping
        self.scoring = scoring
        self.validation_fraction = validation_fraction
        self.n_iter_no_change = n_iter_no_change
        self.tol = tol
        self.random_state = random_state
        self.device = device

    def _bin(self, X: np.ndarray) -> torch.Tensor:
        """Bin indices (rows, features) on the device, int64."""
        Xd = torch.as_tensor(X, dtype=torch.float64, device=self.device).T.contiguous()
        return torch.searchsorted(self._thr_t, Xd, right=False).T.contiguous()

    def fit(self, X, y) -> "HistGradientBoostingClassifier":
        if self.loss != "log_loss" or self.scoring != "loss":
            raise ValueError("the port's HistGradientBoostingClassifier takes loss='log_loss', scoring='loss'")
        X = to_numpy(X) if isinstance(X, torch.Tensor) else np.asarray(X, dtype=np.float64)
        if np.isnan(X).any():
            raise ValueError("the port's HistGradientBoostingClassifier takes no missing values")
        y = labels_of(y)
        self.classes_, codes = np.unique(y, return_inverse=True)
        if len(self.classes_) != 2:
            raise ValueError(f"the port's HistGradientBoostingClassifier is binary; y has {len(self.classes_)} classes")
        y = codes.astype(np.float64)
        rng = check_random_state(self.random_state)
        self._random_seed = rng.randint(np.iinfo(np.uint32).max, dtype="u8")
        rng.randint(np.iinfo(np.uint32).max, dtype="u8")  # sklearn's feature-subsample seed (unused here)
        n_samples, self.n_features_in_ = X.shape
        self.do_early_stopping_ = n_samples > 10_000 if self.early_stopping == "auto" else bool(self.early_stopping)
        if self.do_early_stopping_:
            X_train, X_val, y_train, y_val = train_test_split(
                X, y, test_size=self.validation_fraction, stratify=y, random_state=self._random_seed)
        else:
            X_train, y_train, X_val, y_val = X, y, None, None
        sample = X_train
        if X_train.shape[0] > SUBSAMPLE:
            sample = X_train.take(check_random_state(self._random_seed).choice(X_train.shape[0], SUBSAMPLE,
                                                                                replace=True), axis=0)
        self.bin_thresholds_ = [find_binning_thresholds(sample[:, f], self.max_bins)
                                for f in range(self.n_features_in_)]
        self.n_bins_non_missing_ = np.array([len(t) + 1 for t in self.bin_thresholds_], dtype=np.uint32)
        width = max(1, max(len(t) for t in self.bin_thresholds_))
        thr = np.full((self.n_features_in_, width), np.inf)
        for f, t in enumerate(self.bin_thresholds_):
            thr[f, : len(t)] = t
        self._thr_t = torch.as_tensor(thr, device=self.device)
        dev = self._thr_t.device
        Xb = self._bin(X_train)
        flat = Xb + torch.arange(self.n_features_in_, device=dev)[None, :] * N_BINS
        end = torch.as_tensor(self.n_bins_non_missing_.astype(np.int64) - 1, device=dev)
        y_t = torch.as_tensor(y_train, device=dev)
        p = np.clip(np.average(y_train), 10 * np.finfo(np.float64).eps, 1 - 10 * np.finfo(np.float64).eps)
        self._baseline_prediction = float(np.log(p / (1 - p)))
        raw = torch.full((len(y_train),), self._baseline_prediction, dtype=torch.float64, device=dev)
        ones = torch.ones_like(raw)
        self.train_score_, self.validation_score_ = [], []
        if self.do_early_stopping_:
            Xb_val = self._bin(X_val)
            y_val_t = torch.as_tensor(y_val, device=dev)
            raw_val = torch.full((len(y_val),), self._baseline_prediction, dtype=torch.float64, device=dev)
            self._score(y_t, raw, y_val_t, raw_val)
        self._trees, self.n_leaves_ = [], []
        for _ in range(self.max_iter):
            g, h = gradient_hessian(y_t, raw)
            grower = _TreeGrower(
                flat, Xb, torch.stack([g, h, ones], 1), end, max_leaf_nodes=self.max_leaf_nodes,
                max_depth=self.max_depth, min_samples_leaf=self.min_samples_leaf,
                l2_regularization=self.l2_regularization, shrinkage=self.learning_rate)
            grower.grow()
            tree = grower.predictor(self.bin_thresholds_)
            self._trees.append(tree)
            self.n_leaves_.append(len(grower.leaves))
            if not (grower.root.is_leaf and grower.root.value == 0.0):
                raw = raw + grower.leaf_increments(len(y_train), dev)
            if self.do_early_stopping_:
                raw_val = raw_val + _tree_values(_stack_trees([tree], dev), Xb_val, binned=True)[0]
                if self._score(y_t, raw, y_val_t, raw_val):
                    break
        self.n_iter_ = len(self._trees)
        self.train_score_ = np.asarray(self.train_score_)
        self.validation_score_ = np.asarray(self.validation_score_)
        self._stacked = _stack_trees(self._trees, dev)
        return self

    def _score(self, y, raw, y_val, raw_val) -> bool:
        """``_check_early_stopping_loss``: record the negative losses, then
        ``_should_stop`` on the validation scores."""
        self.train_score_.append(-half_binomial_loss(y, raw))
        self.validation_score_.append(-half_binomial_loss(y_val, raw_val))
        scores = self.validation_score_
        ref = self.n_iter_no_change + 1
        if len(scores) < ref:
            return False
        return not any(s > scores[-ref] + self.tol for s in scores[-ref + 1:])

    def _raw_t(self, X: torch.Tensor) -> torch.Tensor:
        values = _tree_values(self._stacked, X, binned=False)
        raw = torch.full((X.shape[0],), self._baseline_prediction, dtype=torch.float64, device=X.device)
        for v in values:  # tree by tree, as sklearn accumulates
            raw = raw + v
        return raw

    def decision_function(self, X) -> np.ndarray:
        return to_numpy(self._raw_t(as_tensor(X, self.device)))

    def predict_proba(self, X) -> np.ndarray:
        p1 = torch.special.expit(self._raw_t(as_tensor(X, self.device)))
        return to_numpy(torch.stack([1 - p1, p1], 1))

    def _predict_t(self, X: torch.Tensor) -> np.ndarray:
        p1 = torch.special.expit(self._raw_t(X))
        return self.classes_[to_numpy(p1 > 1 - p1).astype(np.int64)]  # argmax of predict_proba

    def predict(self, X) -> np.ndarray:
        return self._predict_t(as_tensor(X, self.device))
