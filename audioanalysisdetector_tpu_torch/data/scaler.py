"""Frame-level standardization (StandardScaler role), PyTorch.

Counterpart of the JAX package's ``data/scaler.py`` (the reference fits
``sklearn.StandardScaler`` on the vstack of all training frames,
reference/ASV_dl_func.py:1113-1129): two numpy arrays, the mean and std
over the coefficient axis, fitted on the host and applied to tensors on
any device; persistence is npz (no pickle), the same files as the JAX
package's. ``prepare_train_test_data_multi`` scales each feature's cells
of a row list with its own scaler, on the host in numpy as the JAX
package does.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class FrameScaler:
    mean: np.ndarray  # (n_coeffs,)
    std: np.ndarray  # (n_coeffs,)

    @staticmethod
    def fit(frames: np.ndarray, *, eps: float = 0.0) -> "FrameScaler":
        """``frames``: (N, n_coeffs) stack of all training frames."""
        mean = frames.mean(axis=0)
        std = frames.std(axis=0)
        std = np.where(std == 0.0, 1.0, std) + eps  # sklearn's zero-var rule
        return FrameScaler(mean=mean.astype(np.float32), std=std.astype(np.float32))

    @staticmethod
    def fit_sequences(seqs: np.ndarray) -> "FrameScaler":
        """``seqs``: (B, T, n_coeffs) batch of time-major sequences."""
        return FrameScaler.fit(np.asarray(seqs).reshape(-1, seqs.shape[-1]))

    def _on(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        return (torch.as_tensor(self.mean, dtype=x.dtype, device=x.device),
                torch.as_tensor(self.std, dtype=x.dtype, device=x.device))

    def transform(self, x: torch.Tensor) -> torch.Tensor:
        """Standardize ``(..., n_coeffs)`` frames (broadcasts over leading axes)."""
        mean, std = self._on(x)
        return (x - mean) / std

    def inverse(self, x: torch.Tensor) -> torch.Tensor:
        mean, std = self._on(x)
        return x * std + mean

    def save(self, path: str) -> None:
        np.savez(path, mean=self.mean, std=self.std)

    @staticmethod
    def load(path: str) -> "FrameScaler":
        with np.load(path) as z:
            return FrameScaler(mean=z["mean"], std=z["std"])


def prepare_train_test_data(
    train_seqs: np.ndarray,
    test_seqs: np.ndarray,
    *,
    scaler_path: str | None = None,
) -> tuple[np.ndarray, np.ndarray, FrameScaler]:
    """Fit on train frames, transform both (the reference's contract,
    reference/ASV_dl_func.py:1113-1129), on the host in float32 as the JAX
    package computes it; ``scaler_path`` keeps the scaler as npz."""
    scaler = FrameScaler.fit_sequences(train_seqs)
    tr = scaler.transform(torch.from_numpy(np.asarray(train_seqs, np.float32))).numpy()
    te = scaler.transform(torch.from_numpy(np.asarray(test_seqs, np.float32))).numpy()
    if scaler_path:
        scaler.save(scaler_path)
    return tr, te, scaler


def prepare_train_test_data_multi(
    train_rows: list[dict],
    test_rows: list[dict],
    feature_cols: list[str],
    *,
    model_dir: str | None = None,
) -> tuple[list[dict], list[dict], dict[str, FrameScaler]]:
    """Per-feature scalers over row cells (the reference's
    ``prepare_train_test_data_multi``, reference/ASV_dl_func.py:1090-1110):
    fit each feature's scaler on the vstack of its train cells, scale both
    splits' cells (new rows; the inputs stay as they were), keep one
    ``{col}_scaler.npz`` per feature under ``model_dir``."""
    train_rows = [dict(r) for r in train_rows]
    test_rows = [dict(r) for r in test_rows]
    scalers: dict[str, FrameScaler] = {}
    for col in feature_cols:
        scaler = FrameScaler.fit(np.vstack([np.asarray(r[col]) for r in train_rows]))
        for rows in (train_rows, test_rows):
            for r in rows:
                r[col] = (np.asarray(r[col]) - scaler.mean) / scaler.std
        if model_dir:
            os.makedirs(model_dir, exist_ok=True)
            scaler.save(os.path.join(model_dir, f"{col}_scaler.npz"))
        scalers[col] = scaler
    return train_rows, test_rows, scalers
