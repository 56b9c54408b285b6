"""Per-feature training sweep + the notebook-cell training drivers (PyTorch).

Counterpart of the JAX package's ``train/sweep.py`` (``train_all_features``
/ ``train_feature_model``, reference/ASV_dl_func.py:872-1029): for every
(optimizer, criterion, feature) cell, standardize that feature on the train
frames, train a fresh ``AntiSpoofingResNet`` and persist the cell's
artifacts — best and final checkpoints, epoch logs (JSON), final metrics
(JSON) and the scaler — in ``{out_dir}/{optimizer}_{criterion}/``.
``train_3features`` (the shared-trunk 3-feature net, ASV_deep_learning.ipynb
cells 32-33) and ``train_mfca`` (MobileNetV2+MFCA, cells 29-31) are the two
notebook drivers, with ``fit``'s run-directory contract.

Models start from ``flax_init_`` drawn from a generator seeded by ``seed``
and train on ``device``. Checkpoints are the JAX package's ``.msgpack``
(``train/checkpoint.py``), the optimizer state in optax's layout of the
sweep's optimizers (``convert.py``): the JAX package restores them.

Data enter as arrays or tensors: ``features[name] = (train_x, test_x)``
with 2-D feature maps per example, plus integer labels.
"""

from __future__ import annotations

import json
import os
from functools import partial

import numpy as np
import torch

from audioanalysisdetector_tpu_torch.data.scaler import FrameScaler
from audioanalysisdetector_tpu_torch.models.layers import flax_init_
from audioanalysisdetector_tpu_torch.models.mobilenet_mfca import MobileNetMFCA
from audioanalysisdetector_tpu_torch.models.resnet import AntiSpoofingResNet, MoreFeaturesClassifier
from audioanalysisdetector_tpu_torch.train.loop import evaluate, fit
from audioanalysisdetector_tpu_torch.train.state import TrainState


def _sweep_optimizer(name: str, lr: float):
    """The reference sweep's hyperparameters (reference/ASV_dl_func.py:978-981)
    as an optimizer factory: SGD at lr 1e-3 with momentum 0.9; Adam with L2
    1e-5 added to the gradient (torch's ``weight_decay``, optax's
    ``chain(add_decayed_weights, adam)``); AdamW with decoupled decay 1e-5."""
    if name == "SGD":
        return partial(torch.optim.SGD, lr=1e-3, momentum=0.9)
    if name == "Adam":
        return partial(torch.optim.Adam, lr=lr, weight_decay=1e-5)
    if name == "AdamW":
        return partial(torch.optim.AdamW, lr=lr, weight_decay=1e-5)
    raise ValueError(f"unknown sweep optimizer {name!r}")


def _state(model: torch.nn.Module, tx, seed: int, device) -> TrainState:
    flax_init_(model, torch.Generator().manual_seed(seed))
    return TrainState.create(model=model.to(device), tx=tx)


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def train_feature_model(
    train_x,
    train_y,
    test_x,
    test_y,
    *,
    feature_name: str,
    optimizer_name: str = "Adam",
    criterion_name: str = "CrossEntropyLoss",
    lr: float = 1e-4,
    epochs: int = 10,
    batch_size: int = 32,
    out_dir: str = "Res_Net",
    seed: int = 0,
    verbose: bool = False,
    device: str | torch.device = "cuda",
) -> dict:
    """One sweep cell: scale -> train -> evaluate -> persist artifacts."""
    cell_dir = os.path.join(out_dir, f"{optimizer_name}_{criterion_name}")
    os.makedirs(cell_dir, exist_ok=True)

    # standardize over all train frames of this feature (the reference's
    # in-loop scaler, reference/ASV_dl_func.py:963-973), on the host
    train_x, test_x = _host(train_x), _host(test_x)
    scaler = FrameScaler.fit(train_x.reshape(-1, train_x.shape[-1]))
    tr = ((train_x - scaler.mean) / scaler.std).astype(np.float32)
    te = ((test_x - scaler.mean) / scaler.std).astype(np.float32)
    scaler.save(os.path.join(cell_dir, f"{feature_name}_scaler.npz"))

    state = _state(AntiSpoofingResNet(), _sweep_optimizer(optimizer_name, lr), seed, device)
    run_dir = os.path.join(cell_dir, feature_name)
    result = fit(
        state, (tr, train_y), (te, test_y),
        loss_name=criterion_name, num_epochs=epochs, batch_size=batch_size,
        seed=seed, run_dir=run_dir, has_batch_stats=True, verbose=verbose, plots=False,
    )
    metrics_best = evaluate(result.best_state, (te, test_y), loss_name=criterion_name)
    metrics_final = evaluate(result.state, (te, test_y), loss_name=criterion_name)

    with open(os.path.join(cell_dir, f"{feature_name}_logs.json"), "w") as f:
        json.dump([l.__dict__ for l in result.logs], f, indent=2)
    with open(os.path.join(cell_dir, f"{feature_name}_metrics.json"), "w") as f:
        json.dump({"best": metrics_best, "final": metrics_final}, f, indent=2)
    return {
        "feature": feature_name,
        "optimizer": optimizer_name,
        "criterion": criterion_name,
        "best": metrics_best,
        "final": metrics_final,
        "run_dir": run_dir,
    }


def _notebook_driver(
    model, tx, tr, train_y, te, test_y, *,
    epochs: int, batch_size: int, out_dir: str, seed: int, verbose: bool, device,
) -> dict:
    """Shared body of the notebook-cell drivers: CrossEntropy ``fit`` with
    the run-dir artifact contract, best and final eval, metrics.json.
    ``tr`` / ``te`` are an array (or tensor) or an aligned tuple of them
    (multi-input models)."""
    state = _state(model, tx, seed, device)
    result = fit(
        state, (tr, train_y), (te, test_y),
        loss_name="CrossEntropyLoss", num_epochs=epochs, batch_size=batch_size,
        seed=seed, run_dir=out_dir, has_batch_stats=True, verbose=verbose, plots=False,
    )
    metrics_best = evaluate(result.best_state, (te, test_y), loss_name="CrossEntropyLoss")
    metrics_final = evaluate(result.state, (te, test_y), loss_name="CrossEntropyLoss")
    with open(os.path.join(out_dir, "metrics.json"), "w") as f:
        json.dump({"best": metrics_best, "final": metrics_final}, f, indent=2)
    return {"best": metrics_best, "final": metrics_final, "run_dir": out_dir}


def _f32(a):
    return a.float() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)


def train_3features(
    train_feats: tuple,
    train_y,
    test_feats: tuple,
    test_y,
    *,
    epochs: int = 50,
    lr: float = 1e-4,
    batch_size: int = 16,
    out_dir: str = "MoreFeatures",
    seed: int = 0,
    verbose: bool = False,
    device: str | torch.device = "cuda",
) -> dict:
    """Train the shared-trunk 3-feature fusion net end to end — the
    notebook's ``train_loop_3features`` (ASV_deep_learning.ipynb cells
    32-33: (cqcc, gtcc, mfcc) UNSCALED through one shared
    ``ExtractFeatureResidual``, CrossEntropy, Adam lr 1e-4, batch 16,
    best state by val loss, final acc/F1/EER).

    ``train_feats`` / ``test_feats``: three aligned (N, H_i, W_i) arrays or
    tensors. Returns {"best": metrics, "final": metrics, "run_dir": ...}."""
    return _notebook_driver(
        MoreFeaturesClassifier(), partial(torch.optim.Adam, lr=lr),
        tuple(_f32(a) for a in train_feats), train_y,
        tuple(_f32(a) for a in test_feats), test_y,
        epochs=epochs, batch_size=batch_size, out_dir=out_dir, seed=seed,
        verbose=verbose, device=device,
    )


def train_mfca(
    train_x,
    train_y,
    test_x,
    test_y,
    *,
    epochs: int = 20,
    lr: float = 1e-4,
    weight_decay: float = 1e-5,
    batch_size: int = 32,
    out_dir: str = "MobileNet-MFCA",
    seed: int = 0,
    verbose: bool = False,
    device: str | torch.device = "cuda",
) -> dict:
    """Train MobileNetV2+MFCA on mel-spectrograms — the notebook's
    ``train_loop_mfca`` (ASV_deep_learning.ipynb cells 29-31: 'mel-spect'
    unscaled, CrossEntropy, Adam lr 1e-4 with L2 weight decay 1e-5 in the
    gradient, batch 32, 20 epochs, best state by val loss)."""
    return _notebook_driver(
        MobileNetMFCA(), partial(torch.optim.Adam, lr=lr, weight_decay=weight_decay),
        _f32(train_x), train_y, _f32(test_x), test_y,
        epochs=epochs, batch_size=batch_size, out_dir=out_dir, seed=seed,
        verbose=verbose, device=device,
    )


def train_all_features(
    features: dict,
    train_y,
    test_y,
    *,
    optimizers: tuple[str, ...] = ("Adam", "AdamW", "SGD"),
    criteria: tuple[str, ...] = ("CrossEntropyLoss", "MSELoss", "L1Loss"),
    epochs: int = 10,
    lr: float = 1e-4,
    batch_size: int = 32,
    out_dir: str = "Res_Net",
    seed: int = 0,
    device: str | torch.device = "cuda",
) -> list[dict]:
    """The full nested sweep (reference defaults: {Adam, AdamW, SGD} x
    {CrossEntropy, MSE, L1} x features, reference/ASV_dl_func.py:945-953)."""
    results = []
    for opt in optimizers:
        for crit in criteria:
            for feat_name, (tr_x, te_x) in features.items():
                results.append(
                    train_feature_model(
                        tr_x, train_y, te_x, test_y,
                        feature_name=feat_name, optimizer_name=opt,
                        criterion_name=crit, lr=lr, epochs=epochs,
                        batch_size=batch_size, out_dir=out_dir, seed=seed, device=device,
                    )
                )
    with open(os.path.join(out_dir, "sweep_summary.json"), "w") as f:
        json.dump(results, f, indent=2, default=float)
    return results
