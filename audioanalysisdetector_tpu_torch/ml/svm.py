"""``SVC`` (binary C-SVC, rbf or linear kernel) in torch float64 on the device.

sklearn's ``SVC`` runs libsvm's ``Solver`` (``svm/src/libsvm/svm.cpp``).
The port solves the same dual on the device:

- the Gram matrix in float64 (libsvm's ``exp(-gamma * (|x|^2 + |y|^2 -
  2 x.y))`` for rbf, ``x.y`` for linear); ``gamma="scale"`` is
  ``1 / (n_features * X.var())``, ``"auto"`` ``1 / n_features``;
- SMO with libsvm's second-order working-set choice (``select_working_set``:
  ``i`` maximises ``-y_t G_t`` over the up set, ``j`` minimises
  ``-(b_ij)^2 / (K_ii + K_jj - 2 K_ij)`` over the low set); each pair moves
  to the clipped optimum along its feasible line, libsvm's update with the
  variables snapped to the box bounds;
- the stop at ``m(alpha) - M(alpha) < min(tol, SMO_TOL)``, well below
  sklearn's ``tol=1e-3``: what is left between the two answers is libsvm's
  own slack at its tolerance (and its float32 kernel cache). libsvm's
  shrinking is not done (it changes the path, not the optimum);
- ``intercept_`` from libsvm's ``calculate_rho`` (the mean of ``y G`` over
  the free variables, else the middle of its bounds).

Labels: ``classes_[1]`` is +1, so ``decision_function`` is positive for
``classes_[1]`` and ``predict`` is its sign, as sklearn's (whose ``predict``
never uses Platt scaling). ``probability=True`` is accepted and fits no
sigmoid: no path of the classical recipes calls ``predict_proba``.
``support_`` lists the support vectors by class, then by index, and
``dual_coef_`` holds ``y alpha`` for them, as sklearn's.

Each SMO step (the selection, the update, the stop flag) stays on the
device; the host reads the flag every ``CHECK_EVERY`` steps. On a card
the block of steps between two reads is recorded once as a CUDA graph and
replayed (on an H100 no slower than the eager loop at 16 rows, recording
included, and 3.4-10.4x faster from 256 rows up: ``chip_smoke.py``'s
``smo_paths``). ``n_iter_`` counts the steps taken.
"""

from __future__ import annotations

import numpy as np
import torch

from audioanalysisdetector_tpu_torch.ml._base import BaseEstimator, as_tensor, labels_of, to_numpy

SMO_TOL = 1e-5
CHECK_EVERY = 32
TAU = 1e-12  # libsvm's floor for a non-positive curvature


def kernel_matrix(A: torch.Tensor, B: torch.Tensor, kernel: str, gamma: float) -> torch.Tensor:
    """libsvm's kernel values between the rows of ``A`` and ``B``, float64."""
    dot = A @ B.T
    if kernel == "linear":
        return dot
    sq_a = (A * A).sum(1)
    sq_b = (B * B).sum(1)
    dot.mul_(-2.0).add_(sq_a[:, None]).add_(sq_b[None, :])
    return dot.mul_(-gamma).exp_()


class _SMO:
    """The dual's state on the device and one SMO step over it, in place
    (so a block of steps can be recorded as a CUDA graph)."""

    def __init__(self, K: torch.Tensor, y: torch.Tensor, C: float, eps: float):
        self.K, self.y, self.C, self.eps = K, y, float(C), float(eps)
        self.Kd = K.diagonal().clone()
        self.yp = y > 0
        # the bound each variable reaches moving up (alpha_t + y_t t) or down
        self.up_bound = torch.where(self.yp, torch.full_like(y, self.C), torch.zeros_like(y))
        self.low_bound = self.C - self.up_bound
        self.alpha = torch.zeros_like(y)
        self.F = -y.clone()  # y * G, G = Q alpha - 1 at alpha = 0
        self.done = torch.zeros((), dtype=torch.bool, device=y.device)
        self.steps = torch.zeros((), dtype=torch.int64, device=y.device)
        self.zero = torch.zeros((), dtype=y.dtype, device=y.device)

    def step(self) -> None:
        K, C, F, alpha = self.K, self.C, self.F, self.alpha
        # u: how far each variable may move in its "up" direction (y_t t, t >= 0)
        u = torch.where(self.yp, C - alpha, alpha)
        low = u < C
        s_up = torch.where(u > 0, -F, -torch.inf)
        i = torch.argmax(s_up).view(1)
        gmax = s_up.index_select(0, i)
        Ki = K.index_select(0, i)[0]
        b = F + gmax
        quad = self.Kd + self.Kd.index_select(0, i) - 2.0 * Ki
        quad = torch.where(quad > 0, quad, TAU)
        obj = torch.where(low & (b > 0), -(b * b) / quad, torch.inf)
        j = torch.argmin(obj).view(1)
        # the scalars of the pair: alpha, y, u, b, quad, obj at i (column 0) and j
        a, y, u_, b_, q, o = torch.stack([alpha, self.y, u, b, quad, obj]).index_select(1, torch.cat([i, j]))
        self.done |= ((gmax + torch.where(low, F, -torch.inf).max() < self.eps) | torch.isinf(o[1]))[0]
        go = ~self.done
        room_i, room_j = u_[0], C - u_[1]
        t = torch.where(go, torch.minimum(torch.minimum(b_[1] / q[1], room_i), room_j), self.zero)
        # libsvm sets a clipped variable to its bound exactly
        new = torch.stack([torch.where(go & (t == room_i), self.up_bound.index_select(0, i)[0], a[0] + y[0] * t),
                           torch.where(go & (t == room_j), self.low_bound.index_select(0, j)[0], a[1] - y[1] * t)])
        d = (new - a) * y
        F.addcmul_(Ki, d[0]).addcmul_(K.index_select(0, j)[0], d[1])
        alpha.index_copy_(0, torch.cat([i, j]), new)
        self.steps += go

    def solve(self, max_iter: int, graph: bool) -> int:
        block = None
        if graph:
            stream = torch.cuda.Stream()
            stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(stream):
                for _ in range(3):  # warm-up before recording, on the side stream
                    self.step()
            torch.cuda.current_stream().wait_stream(stream)
            block = torch.cuda.CUDAGraph()
            with torch.cuda.graph(block):
                for _ in range(CHECK_EVERY):
                    self.step()
        while not bool(self.done) and int(self.steps) < max_iter:
            if block is not None:
                block.replay()
            else:
                for _ in range(CHECK_EVERY):
                    self.step()
        return int(self.steps)

    def rho(self) -> float:
        """libsvm's ``calculate_rho``."""
        yG, alpha, y, C = self.F, self.alpha, self.y, self.C
        at_upper, at_lower = alpha >= C, alpha <= 0
        free = ~(at_upper | at_lower)
        if bool(free.any()):
            return float(yG[free].mean())
        ub_mask = (at_upper & (y < 0)) | (at_lower & (y > 0))
        lb_mask = (at_upper & (y > 0)) | (at_lower & (y < 0))
        ub = float(yG[ub_mask].min()) if bool(ub_mask.any()) else np.inf
        lb = float(yG[lb_mask].max()) if bool(lb_mask.any()) else -np.inf
        return (ub + lb) / 2


class SVC(BaseEstimator):
    """Binary C-SVC on the device (see the module docstring)."""

    def __init__(self, *, C: float = 1.0, kernel: str = "rbf", gamma="scale", tol: float = 1e-3,
                 probability: bool = False, max_iter: int = -1, random_state=None,
                 device: str | torch.device = "cuda"):
        self.C = C
        self.kernel = kernel
        self.gamma = gamma
        self.tol = tol
        self.probability = probability
        self.max_iter = max_iter
        self.random_state = random_state
        self.device = device

    def _gamma_for(self, X: torch.Tensor) -> float:
        if self.gamma == "scale":
            var = float(X.var(correction=0))
            return 1.0 / (X.shape[1] * var) if var != 0 else 1.0
        if self.gamma == "auto":
            return 1.0 / X.shape[1]
        return float(self.gamma)

    def _fit_t(self, X: torch.Tensor, y) -> "SVC":
        if self.kernel not in ("rbf", "linear"):
            raise ValueError(f"kernel={self.kernel!r}: the port's SVC has 'rbf' and 'linear'")
        y = labels_of(y)
        self.classes_, codes = np.unique(y, return_inverse=True)
        if len(self.classes_) != 2:
            raise ValueError(f"the port's SVC is binary; y has {len(self.classes_)} classes")
        self._gamma = self._gamma_for(X)
        sign = torch.as_tensor(2.0 * codes - 1.0, dtype=torch.float64, device=X.device)
        K = kernel_matrix(X, X, self.kernel, self._gamma)
        smo = _SMO(K, sign, self.C, min(self.tol, SMO_TOL))
        n = X.shape[0]
        max_iter = self.max_iter if self.max_iter > 0 else max(10_000_000, 100 * n)
        steps = smo.solve(max_iter, graph=X.device.type == "cuda")
        rho = smo.rho()
        alpha = to_numpy(smo.alpha)
        del K, smo
        # support vectors by class (classes_[0] first), each by index
        order = np.concatenate([np.flatnonzero((alpha > 0) & (codes == c)) for c in (0, 1)])
        self.support_ = order.astype(np.int32)
        self.n_support_ = np.array([np.sum(codes[order] == c) for c in (0, 1)], dtype=np.int32)
        self._sv_t = X[torch.as_tensor(order, device=X.device)]
        self.support_vectors_ = to_numpy(self._sv_t)
        self.dual_coef_ = ((2.0 * codes[order] - 1.0) * alpha[order])[None, :]
        self.intercept_ = np.array([-rho])
        self.n_iter_ = np.array([steps], dtype=np.int32)
        self.n_features_in_ = X.shape[1]
        self._dual_t = torch.as_tensor(self.dual_coef_[0], device=X.device)
        return self

    def fit(self, X, y) -> "SVC":
        return self._fit_t(as_tensor(X, self.device), y)

    def _decision_t(self, X: torch.Tensor) -> torch.Tensor:
        K = kernel_matrix(X, self._sv_t, self.kernel, self._gamma)
        return K @ self._dual_t + float(self.intercept_[0])

    def _predict_t(self, X: torch.Tensor) -> np.ndarray:
        return self.classes_[to_numpy(self._decision_t(X) >= 0).astype(np.int64)]

    def decision_function(self, X) -> np.ndarray:
        return to_numpy(self._decision_t(as_tensor(X, self.device)))

    def predict(self, X) -> np.ndarray:
        return self._predict_t(as_tensor(X, self.device))
