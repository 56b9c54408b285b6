"""Training loops: the generic epoch loop and the BiLSTM flagship pipeline (PyTorch).

Counterpart of the JAX package's ``train/loop.py``: per-epoch train/val
passes, best/worst checkpoints by val loss (in the JAX package's ``.msgpack``
format, ``train/checkpoint.py``), txt+CSV+JSON logs and loss/accuracy plots
per run directory, final accuracy/F1/EER on the best state.

Data enter as numpy arrays or as tensors (on the model's device, where no
batch crosses the host): ``batch_iter`` walks the same seeded permutation as
the JAX package's and pads the tail batch the same cyclic way, so both
packages train on the same rows. Training pads the tail batch with repeated
rows and weights the metric averages by true counts; evaluation leaves the
tail unpadded so val loss, which picks the best checkpoint, is exact.
Metrics accumulate on the device: one host sync per epoch.

Data-parallel training (``data_parallel=True``) is ROADMAP Queue 1 step 9.
"""

from __future__ import annotations

import json
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, Iterator

import numpy as np
import torch

from audioanalysisdetector_tpu_torch.data.bucketing import bucketed_batches, make_bucket_ladder
from audioanalysisdetector_tpu_torch.models.bilstm_classifier import BiLSTMClassifier
from audioanalysisdetector_tpu_torch.models.layers import flax_init_
from audioanalysisdetector_tpu_torch.train import metrics as M
from audioanalysisdetector_tpu_torch.train.checkpoint import save_checkpoint
from audioanalysisdetector_tpu_torch.train.losses import get_loss, get_loss_per_row
from audioanalysisdetector_tpu_torch.train.optimizers import make_optimizer
from audioanalysisdetector_tpu_torch.train.state import TrainState
from audioanalysisdetector_tpu_torch.train.steps import _ieee_fp32, make_eval_step, make_train_step

Data = np.ndarray | torch.Tensor | tuple


def batch_iter(
    x: Data,
    y: np.ndarray | torch.Tensor,
    batch_size: int,
    *,
    shuffle: bool,
    seed: int = 0,
    pad_tail: bool = True,
) -> Iterator[tuple[Data, np.ndarray | torch.Tensor, int]]:
    """Yield (x_batch, y_batch, true_count); tail batch padded to full size.

    ``x`` may be a tuple of arrays (multi-input models); rows stay aligned.
    Tensors are indexed on their own device, with one upload of the
    epoch's row order."""
    n = len(y)
    idx = np.arange(n)
    if shuffle:
        np.random.default_rng(seed).shuffle(idx)
    sels = []
    for start in range(0, n, batch_size):
        sel = idx[start : start + batch_size]
        true = len(sel)
        if true < batch_size and pad_tail:
            # np.resize tiles idx cyclically, so the padded batch reaches the
            # FULL batch_size even when the whole dataset is smaller than one
            # batch
            sel = np.concatenate([sel, np.resize(idx, batch_size - true)])
        sels.append((sel, true))
    order = np.concatenate([s for s, _ in sels]) if sels else idx
    on_device: dict = {}

    def take(a, lo: int, hi: int):
        if isinstance(a, tuple):
            return tuple(take(ai, lo, hi) for ai in a)
        if isinstance(a, torch.Tensor):
            if a.device not in on_device:
                on_device[a.device] = torch.from_numpy(order).to(a.device)
            return a[on_device[a.device][lo:hi]]
        return a[order[lo:hi]]

    lo = 0
    for sel, true in sels:
        yield take(x, lo, lo + len(sel)), take(y, lo, lo + len(sel)), true
        lo += len(sel)


def _to(a, device: torch.device):
    """A batch (tuple-aware) as tensors on ``device``."""
    if isinstance(a, tuple):
        return tuple(_to(ai, device) for ai in a)
    if isinstance(a, torch.Tensor):
        return a.to(device)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _labels(y, device: torch.device) -> torch.Tensor:
    return _to(y, device).to(torch.int64)


def _device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


@dataclass
class EpochLog:
    epoch: int
    train_loss: float
    train_acc: float
    val_loss: float
    val_acc: float
    seconds: float


@dataclass
class FitResult:
    state: TrainState
    best_state: TrainState
    logs: list[EpochLog] = field(default_factory=list)
    best_epoch: int = -1
    # fit_bucketed: the distinct (B, T) input shapes its train step saw (the
    # JAX package counts the jit cache entries, one per shape)
    n_compiled_shapes: int = -1


def _save_best_worst(run_dir: str | None, name: str, state: TrainState, epoch: int, val_loss: float) -> None:
    if run_dir:
        save_checkpoint(os.path.join(run_dir, name), state,
                        metadata={"epoch": epoch, "val_loss": val_loss})


def fit(
    state: TrainState,
    train_data: tuple,
    val_data: tuple,
    *,
    loss_name: str = "CrossEntropyLoss",
    num_epochs: int = 10,
    batch_size: int = 16,
    seed: int = 0,
    run_dir: str | None = None,
    has_batch_stats: bool = True,
    binary_head: bool = False,
    step_fn: Callable | None = None,
    verbose: bool = False,
    plots: bool = True,
    data_parallel: bool | None = None,
) -> FitResult:
    """Generic epoch loop (the reference ``train_loop`` contract) on the
    device of ``state.model``. The dropout masks come from one
    ``torch.Generator`` on that device seeded by ``seed``; epoch ``e``
    shuffles with ``seed + e``. ``best_state`` is a copy taken at the best
    val loss. ``data_parallel``: ``None`` and ``False`` train on one device,
    ``True`` raises ``NotImplementedError`` (ROADMAP Queue 1 step 9)."""
    if data_parallel:
        raise NotImplementedError(
            "data-parallel training is not ported yet (ROADMAP Queue 1 step 9); "
            "pass data_parallel=None or False to train on one device"
        )
    loss_fn = get_loss(loss_name)
    step = step_fn or make_train_step(loss_fn, has_batch_stats=has_batch_stats, binary_head=binary_head)
    eval_step = make_eval_step(loss_fn, has_batch_stats=has_batch_stats, binary_head=binary_head)
    device = _device(state.model)
    generator = torch.Generator(device=device).manual_seed(seed)

    logs: list[EpochLog] = []
    best_val = float("inf")
    worst_val = -float("inf")
    best_state = state.copy()
    best_epoch = -1

    for epoch in range(num_epochs):
        t0 = time.time()
        tr_loss_d = tr_acc_d = None
        tr_n = 0.0
        for xb, yb, true in batch_iter(*train_data, batch_size, shuffle=True, seed=seed + epoch):
            state, m = step(state, _to(xb, device), _labels(yb, device), generator)
            dl, da = m["loss"] * true, m["accuracy"] * true
            tr_loss_d = dl if tr_loss_d is None else tr_loss_d + dl
            tr_acc_d = da if tr_acc_d is None else tr_acc_d + da
            tr_n += true

        va_loss_d = va_acc_d = None
        va_n = 0.0
        for xb, yb, true in batch_iter(*val_data, batch_size, shuffle=False, pad_tail=False):
            m = eval_step(state, _to(xb, device), _labels(yb, device))
            dl, da = m["loss"] * true, m["accuracy"] * true
            va_loss_d = dl if va_loss_d is None else va_loss_d + dl
            va_acc_d = da if va_acc_d is None else va_acc_d + da
            va_n += true
        # the epoch's one host sync
        sums = [float(t) if t is not None else 0.0 for t in (tr_loss_d, tr_acc_d, va_loss_d, va_acc_d)]

        row = EpochLog(
            epoch=epoch,
            train_loss=sums[0] / max(tr_n, 1),
            train_acc=sums[1] / max(tr_n, 1),
            val_loss=sums[2] / max(va_n, 1),
            val_acc=sums[3] / max(va_n, 1),
            seconds=time.time() - t0,
        )
        logs.append(row)
        if verbose:
            print(
                f"epoch {epoch}: train loss {row.train_loss:.4f} acc {row.train_acc:.4f}"
                f" | val loss {row.val_loss:.4f} acc {row.val_acc:.4f} ({row.seconds:.1f}s)"
            )

        if row.val_loss < best_val:
            best_val = row.val_loss
            best_state = state.copy()
            best_epoch = epoch
            _save_best_worst(run_dir, "best_model.msgpack", state, epoch, row.val_loss)
        if row.val_loss > worst_val:
            worst_val = row.val_loss
            _save_best_worst(run_dir, "worst_model.msgpack", state, epoch, row.val_loss)

    if run_dir:
        _write_run_artifacts(
            run_dir, logs, loss_name=loss_name, num_epochs=num_epochs,
            batch_size=batch_size, best_epoch=best_epoch, best_val=best_val,
            final_state=state, plots=plots,
        )

    return FitResult(state=state, best_state=best_state, logs=logs, best_epoch=best_epoch)


def _write_run_artifacts(
    run_dir: str,
    logs: list[EpochLog],
    *,
    loss_name: str,
    num_epochs: int,
    batch_size: int,
    best_epoch: int,
    best_val: float,
    final_state: TrainState | None,
    plots: bool = True,
) -> None:
    """The per-run artifact contract shared by ``fit`` and ``fit_bucketed``:
    CSV + human txt + JSON epoch logs, final checkpoint, loss/accuracy PNGs
    (reference/ASV_dl_func.py:1332-1382)."""
    os.makedirs(run_dir, exist_ok=True)
    csv_rows = ["epoch,train_loss,train_acc,val_loss,val_acc,seconds"] + [
        f"{r.epoch},{r.train_loss:.6f},{r.train_acc:.6f},"
        f"{r.val_loss:.6f},{r.val_acc:.6f},{r.seconds:.3f}"
        for r in logs
    ]
    with open(os.path.join(run_dir, "training_log.csv"), "w") as f:
        f.write("\n".join(csv_rows) + "\n")
    with open(os.path.join(run_dir, "training_log.txt"), "w") as f:
        f.write(f"Training | loss: {loss_name} | epochs: {num_epochs} "
                f"| batch: {batch_size}\n" + "=" * 80 + "\n")
        for row in logs:
            f.write(
                f"epoch {row.epoch}: train loss {row.train_loss:.6f} "
                f"acc {row.train_acc:.4f} | val loss {row.val_loss:.6f} "
                f"acc {row.val_acc:.4f} ({row.seconds:.2f}s)\n"
            )
        f.write(f"best epoch: {best_epoch} (val loss {best_val:.6f})\n")
    with open(os.path.join(run_dir, "logs.json"), "w") as f:
        json.dump([row.__dict__ for row in logs], f, indent=2)
    if final_state is not None:
        save_checkpoint(os.path.join(run_dir, "final_model.msgpack"), final_state)
    if plots:
        _save_plots(logs, run_dir)


def fit_bucketed(
    model: torch.nn.Module,
    train_sequences: list[np.ndarray],
    train_labels: np.ndarray,
    val_sequences: list[np.ndarray],
    val_labels: np.ndarray,
    *,
    loss_name: str = "CrossEntropyLoss",
    optimizer_name: str = "Adam",
    lr: float = 1e-3,
    num_epochs: int = 5,
    batch_size: int = 16,
    n_buckets: int = 4,
    seed: int = 0,
    run_dir: str | None = None,
    verbose: bool = False,
    plots: bool = True,
) -> FitResult:
    """Ragged-corpus trainer: variable-length sequences over length buckets.

    ``model`` takes ``(x, lengths=, generator=)`` (``BiLSTMClassifier``); its
    parameters are redrawn with ``flax_init_`` from a generator seeded by
    ``seed``, and it trains on its own device. Sequences ``(T_i, F)`` are
    grouped by ``data.bucketing`` into the JAX package's quantized length
    ladder; padded frames are zero and each sequence's logits read its TRUE
    last step. Tail batches fill with cyclic repeats that a 0/1 row mask
    keeps out of the gradient and the metric sums, so the val loss that
    picks the best checkpoint is exact. ``run_dir`` gets ``fit``'s artifact
    contract. ``FitResult.n_compiled_shapes`` is the number of distinct
    ``(B, T)`` shapes the train step saw."""
    loss_per_row = get_loss_per_row(loss_name)
    _ieee_fp32()
    ladder = make_bucket_ladder(
        np.asarray([len(s) for s in train_sequences] + [len(s) for s in val_sequences]),
        n_buckets,
    )
    flax_init_(model, torch.Generator().manual_seed(seed))
    state = TrainState.create(model=model, tx=make_optimizer(optimizer_name, lr))
    device = _device(model)
    generator = torch.Generator(device=device).manual_seed(seed)
    shapes: set[tuple[int, ...]] = set()

    def batch(xb, lb, yb, n_true):
        mask = (torch.arange(len(yb), device=device) < n_true).to(torch.float32)
        return _to(xb, device), _labels(lb, device), _labels(yb, device), mask

    def sums(logits, y, mask):
        correct = (torch.argmax(logits, -1) == y).to(torch.float32)
        return (loss_per_row(logits, y) * mask).sum(), (correct * mask).sum()

    logs: list[EpochLog] = []
    best_val = float("inf")
    worst_val = -float("inf")
    best_state = state.copy()
    best_epoch = -1
    for epoch in range(num_epochs):
        t0 = time.time()
        tr = torch.zeros(2, device=device)
        tr_n = 0.0
        model.train()
        for xb, lb, yb, n_true in bucketed_batches(
            train_sequences, train_labels, batch_size,
            ladder=ladder, shuffle=True, seed=seed + epoch,
        ):
            x, lengths, y, mask = batch(xb, lb, yb, n_true)
            shapes.add(tuple(x.shape[:2]))
            loss_sum, correct = sums(model(x, lengths=lengths, generator=generator), y, mask)
            state.optimizer.zero_grad(set_to_none=True)
            (loss_sum / mask.sum()).backward()
            state.apply_gradients()
            tr += torch.stack([loss_sum.detach(), correct])
            tr_n += n_true

        va = torch.zeros(2, device=device)
        va_n = 0.0
        model.eval()
        with torch.no_grad():
            for xb, lb, yb, n_true in bucketed_batches(
                val_sequences, val_labels, batch_size, ladder=ladder, shuffle=False
            ):
                x, lengths, y, mask = batch(xb, lb, yb, n_true)
                va += torch.stack(sums(model(x, lengths=lengths), y, mask))
                va_n += n_true

        (tr_loss, tr_acc), (va_loss, va_acc) = tr.tolist(), va.tolist()
        row = EpochLog(
            epoch=epoch,
            train_loss=tr_loss / max(tr_n, 1),
            train_acc=tr_acc / max(tr_n, 1),
            val_loss=va_loss / max(va_n, 1),
            val_acc=va_acc / max(va_n, 1),
            seconds=time.time() - t0,
        )
        logs.append(row)
        if verbose:
            print(
                f"epoch {epoch}: train loss {row.train_loss:.4f} acc {row.train_acc:.4f}"
                f" | val loss {row.val_loss:.4f} acc {row.val_acc:.4f}"
            )
        if row.val_loss < best_val:
            best_val, best_state, best_epoch = row.val_loss, state.copy(), epoch
            _save_best_worst(run_dir, "best_model.msgpack", state, epoch, row.val_loss)
        if row.val_loss > worst_val:
            worst_val = row.val_loss
            _save_best_worst(run_dir, "worst_model.msgpack", state, epoch, row.val_loss)

    if run_dir:
        _write_run_artifacts(
            run_dir, logs, loss_name=loss_name, num_epochs=num_epochs,
            batch_size=batch_size, best_epoch=best_epoch, best_val=best_val,
            final_state=state, plots=plots,
        )

    return FitResult(
        state=state, best_state=best_state, logs=logs, best_epoch=best_epoch,
        n_compiled_shapes=len(shapes),
    )


def _save_plots(logs: list[EpochLog], run_dir: str) -> None:
    """Loss/accuracy curves, the reference's per-run PNGs
    (reference/ASV_dl_func.py:1363-1382). Without matplotlib they are
    skipped with one line on stderr; nothing else of the run changes."""
    try:
        import matplotlib
    except ImportError:
        print(f"matplotlib is not installed: no loss/accuracy curves in {run_dir}", file=sys.stderr)
        return

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    epochs = [l.epoch for l in logs]
    for what, fname in (("loss", "loss_curve.png"), ("acc", "accuracy_curve.png")):
        fig, ax = plt.subplots(figsize=(7, 4))
        ax.plot(epochs, [getattr(l, f"train_{what}") for l in logs], label="train")
        ax.plot(epochs, [getattr(l, f"val_{what}") for l in logs], label="val")
        ax.set_xlabel("epoch")
        ax.set_ylabel(what)
        ax.legend()
        fig.tight_layout()
        fig.savefig(os.path.join(run_dir, fname), dpi=100)
        plt.close(fig)


def evaluate(
    state: TrainState,
    data: tuple,
    *,
    loss_name: str = "CrossEntropyLoss",
    batch_size: int = 256,
    has_batch_stats: bool = True,
    binary_head: bool = False,
) -> dict[str, float]:
    """Final metrics on a dataset: accuracy, F1, EER (+ mean loss)."""
    if len(data[1]) == 0:
        raise ValueError("evaluate: empty dataset (no rows after filtering)")
    eval_step = make_eval_step(get_loss(loss_name), has_batch_stats=has_batch_stats, binary_head=binary_head)
    device = _device(state.model)
    preds, scores, losses = [], [], []
    for xb, yb, true in batch_iter(*data, batch_size, shuffle=False, pad_tail=False):
        m = eval_step(state, _to(xb, device), _labels(yb, device))
        preds.append(m["preds"])
        scores.append(m["scores"])
        losses.append(m["loss"] * true)
    out = M.model_result_metrics(
        _host(data[1]), torch.cat(preds).cpu().numpy(), torch.cat(scores).cpu().numpy()
    )
    out["loss"] = float(torch.stack(losses).sum()) / len(data[1])
    return out


def bilstm_pipeline(
    train_data: tuple,
    test_data: tuple,
    *,
    num_epochs: int = 100,
    criterion_name: str = "CrossEntropyLoss",
    optimizer_name: str = "Adam",
    lr: float = 1e-4,
    batch_size: int = 16,
    hidden: int = 128,
    model_dir: str = "GMM-BiLSTM",
    seed: int = 0,
    verbose: bool = False,
    device: str | torch.device = "cuda",
) -> tuple[FitResult, dict[str, float]]:
    """The flagship trainer (reference ``BiLSTM_model`` contract) on
    ``device``: config-named run dir, best/worst checkpoints, CSV/JSON logs
    + plots, final accuracy/F1/EER of the best state. The model starts from
    ``flax_init_`` drawn from a generator seeded by ``seed``.

    ``train_data[0]``: time-major CQCC ``(N, T, F)`` float32; labels int."""
    config_name = f"{optimizer_name}_{criterion_name}_lr{lr}".replace(".", "_")
    run_dir = os.path.join(model_dir, config_name)
    os.makedirs(run_dir, exist_ok=True)

    x_train = train_data[0]
    model = BiLSTMClassifier(hidden=hidden, input_dim=x_train.shape[-1])
    flax_init_(model, torch.Generator().manual_seed(seed))
    state = TrainState.create(model=model.to(device), tx=make_optimizer(optimizer_name, lr))
    result = fit(
        state,
        train_data,
        test_data,
        loss_name=criterion_name,
        num_epochs=num_epochs,
        batch_size=batch_size,
        seed=seed,
        run_dir=run_dir,
        has_batch_stats=False,
        verbose=verbose,
    )
    final = evaluate(
        result.best_state, test_data, loss_name=criterion_name, has_batch_stats=False
    )
    with open(os.path.join(run_dir, "metrics.json"), "w") as f:
        json.dump(final, f, indent=2)
    return result, final
