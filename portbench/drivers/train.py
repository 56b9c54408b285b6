"""Training: the ``train`` command's path without decoding, driven in
one-epoch ``train/loop.py::fit`` calls that carry one training state.

Set-up makes the corpus from the seed on the device (``utterances`` 2-s
rows, a share ``spoof_share`` of them spoofed: a tone near
``spoof_tone_hz`` added), the weights, and the system's ``trainer`` (features
through the port's frontend, the 80/20 split, the model, Adam). It then
drives that state through its first ``first_steps`` steps, each a
one-epoch ``fit`` over ``batch`` rows no other step sees, which also warms
every shape; the window repeats one-epoch ``fit`` calls over the whole
train split, validation and checkpoints included, until ``--seconds`` have
passed. End-to-end: ``train_utt_per_s``, train utterances stepped over the
window's time.

``correct``: the plain reference (``reference/mel_train.py``) follows the
first steps from the same weights, waveforms, row orders and dropout
seeds. Compared are BatchNorm's running statistics after the first step
(the widest gap over the widest value), the widest relative gap of every
step's loss, and each leaf's change after the last step by the worst
leaf: the difference of the norms over the larger of the reference's norm
of that leaf and of the median leaf. The first gradient as Adam holds it
after one step is read per leaf (stderr) and not held to a limit: where
the max over the steps meets a near tie, rounding routes one row's
gradient to another step, and the leaves upstream of it read up to 1e-3
on a few seeds (``PERF.md`` §7); the first step's statistics, which no tie
moves, stand in for it. Leaves whose reference gradient is under
``cfg["compare"]["min_leaf_grad"]`` of the median leaf's move by rounding
alone and are left out.
"""

from __future__ import annotations

import math
import shutil
import tempfile
import time

import torch

from portbench.harness import audio
from portbench.harness.cells import BENCH_DIR, load_module
from portbench.harness.result import Outcome, sync
from portbench.harness.trace import Window


def inputs(cell, system, seed: int, device: str):
    """(weights, labels, waveforms), all made on ``device`` from ``seed``."""
    cfg, tr = cell.config, cell.traffic
    g = audio.seed_generator(seed, device)
    weights = system.make_weights(cfg, g, device, tr["audio"])
    n = int(tr["utterances"])
    labels = (torch.rand(n, generator=g, device=device) < float(tr["spoof_share"])).to(torch.int64)
    wav = audio.waves(n, cfg["n_samples"], cfg["sr"], g, device, tr["audio"])
    f = float(tr["spoof_tone_hz"]) * (1.0 + 0.05 * torch.rand((n, 1), generator=g, device=device))
    t = torch.arange(cfg["n_samples"], device=device, dtype=torch.float32) / cfg["sr"]
    wav += (labels[:, None] * 0.05) * torch.sin(2.0 * math.pi * f * t)
    return weights, labels, wav


def first_seeds(seed: int, k: int) -> list[int]:
    base = int(seed) % (1 << 31)
    return [base + i for i in range(k)]


def leaf_gaps(prog: dict, ref: dict, keep: list[str]) -> dict[str, float]:
    """Per leaf: |‖prog‖ - ‖ref‖| over max(‖ref‖ of the leaf, of the median leaf)."""
    norms = {k: float(ref[k].norm()) for k in keep}
    median = sorted(norms.values())[len(norms) // 2]
    return {k: abs(float(prog[k].double().norm()) - norms[k]) / max(norms[k], median) for k in keep}


def run(cell, *, seed: int, seconds: float, trace: bool, device: str, t_start: float) -> Outcome:
    from audioanalysisdetector_tpu_torch.train.loop import fit

    cfg, tr = cell.config, cell.traffic
    system = cell.system()
    weights, labels, wav = inputs(cell, system, seed, device)
    state, train, val = system.trainer(cfg, tr, weights, wav, labels, device)
    batch, k = int(tr["batch"]), int(tr["first_steps"])
    first_wav = wav[: k * batch].clone()
    del wav
    before = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    run_dir = tempfile.mkdtemp(prefix="portbench-train-")
    fit_args = dict(loss_name=tr["loss"], num_epochs=1, batch_size=batch, run_dir=run_dir,
                    binary_head=True, plots=False)
    try:
        losses, first_grad, bn_stats = [], None, None
        seeds = first_seeds(seed, k)
        for i, s in enumerate(seeds):
            rows = slice(i * batch, (i + 1) * batch)
            res = fit(state, (train[0][rows], train[1][rows]), val, seed=s, **fit_args)
            losses.append(res.logs[0].train_loss)
            if first_grad is None:
                bn_stats = {n: b.detach().clone() for n, b in state.model.named_buffers() if "running" in n}
                opt = state.optimizer
                first_grad = {n: (opt.state[p]["exp_avg"] / (1 - opt.param_groups[0]["betas"][0])
                                  if "exp_avg" in opt.state[p] else torch.zeros_like(p))
                              for n, p in state.model.named_parameters()}
        change = {n: p.detach() - before[n] for n, p in state.model.named_parameters()}
        sync(device)
        setup_s = time.perf_counter() - t_start

        epochs = 0
        with Window(trace, device) as window:
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < seconds:
                fit(state, train, val, seed=seeds[-1] + 1 + epochs, **fit_args)
                epochs += 1
            sync(device)
            elapsed = time.perf_counter() - t0
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
    stepped = epochs * len(train[1])
    out = Outcome(setup_s=setup_s, attempted=stepped)
    out.end_to_end["train_utt_per_s"] = stepped / elapsed
    out.note_memory(device)
    if trace:
        out.trace = window.summary
        out.context.update(rate_utt_per_s=stepped / elapsed, train_ops=system.train_ops,
                           **step_readings(state, train, tr, device))
    del train, val

    ref = reference_steps(cell, weights, first_wav, labels, seeds)
    got = {"losses": losses, "first_grad": first_grad, "bn_stats": bn_stats, "change": change}
    for name, value in gaps(cell, got, ref, out).items():
        out.check(name, value, cfg["limits"][name])
    out.failed = sum(1 for _, v, lim in out.checks if not v <= lim)
    return out


def reference_steps(cell, weights: dict, first_wav: torch.Tensor, labels: torch.Tensor, seeds: list[int],
                    dtype: torch.dtype = torch.float64) -> dict:
    cfg, batch = cell.config, int(cell.traffic["batch"])
    module = load_module(BENCH_DIR / "reference" / f"{cfg['train_reference']}.py",
                         f"portbench_reference_{cfg['train_reference']}")
    return module.steps(cfg, cell.traffic, weights,
                        [(first_wav[i * batch:(i + 1) * batch], labels[i * batch:(i + 1) * batch], s)
                         for i, s in enumerate(seeds)], dtype=dtype)


def gaps(cell, got: dict, ref: dict, out: Outcome | None = None) -> dict[str, float]:
    """The three numbers compared, of ``got`` against the reference's
    ``ref``; leaves the rule leaves out are named in ``out``'s context."""
    names = list(ref["first_grad"])
    norms = {n: float(ref["first_grad"][n].norm()) for n in names}
    median = sorted(norms.values())[len(norms) // 2]
    keep = [n for n in names if norms[n] >= cell.config["compare"]["min_leaf_grad"] * median]
    grad = leaf_gaps(got["first_grad"], ref["first_grad"], keep)
    change = leaf_gaps(got["change"], ref["change"], keep)
    losses = [abs(a - b) / abs(b) for a, b in zip(got["losses"], ref["losses"])]
    if out is not None:
        out.context["left_out"] = ", ".join(n for n in names if n not in keep)
        out.context["readings"] = {"loss_by_step": losses, "grad_by_leaf": grad, "change_by_leaf": change}
    bn = max(float((got["bn_stats"][k].double() - v).abs().max() / v.abs().max()) for k, v in ref["bn_stats"].items())
    return {"bn_stats_gap": bn, "loss_gap": max(losses), "change_gap": max(change.values())}


def control(cell, seed: int, device: str) -> dict[str, float]:
    """The numbers compared, read off the control: the reference's steps at
    float32 with TF32 on against its float64 steps, on the inputs of
    ``seed``."""
    from portbench.reference.common import precision

    weights, labels, wav = inputs(cell, cell.system(), seed, device)
    k, batch = int(cell.traffic["first_steps"]), int(cell.traffic["batch"])
    first_wav, seeds = wav[: k * batch].clone(), first_seeds(seed, k)
    del wav
    exact = reference_steps(cell, weights, first_wav, labels, seeds)
    with precision(tf32=True):
        low = reference_steps(cell, weights, first_wav, labels, seeds, dtype=torch.float32)
    return gaps(cell, low, exact)


def step_readings(state, train, tr: dict, device: str, steps: int = 50) -> dict:
    """After the window: ms per train step (CUDA events over ``steps``
    steps of ``make_train_step`` on the cell's batches) and kernels
    launched per step (a profiler over a tenth as many)."""
    from torch.profiler import ProfilerActivity, profile

    from audioanalysisdetector_tpu_torch.train.losses import get_loss
    from audioanalysisdetector_tpu_torch.train.steps import make_train_step

    batch = int(tr["batch"])
    step = make_train_step(get_loss(tr["loss"]), has_batch_stats=True, binary_head=True)
    gen = torch.Generator(device=device).manual_seed(0)
    xs = [train[0][i * batch:(i + 1) * batch] for i in range(4)]
    ys = [train[1][i * batch:(i + 1) * batch] for i in range(4)]
    for i in range(2):
        step(state, xs[i], ys[i], gen)
    sync(device)
    if not str(device).startswith("cuda"):
        return {}
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(steps):
        step(state, xs[i % 4], ys[i % 4], gen)
    end.record()
    end.synchronize()
    n = max(steps // 10, 1)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            step(state, xs[i % 4], ys[i % 4], gen)
        sync(device)
    from torch.autograd import DeviceType

    kernels = sum(1 for e in prof.profiler.kineto_results.events()
                  if e.device_type() == DeviceType.CUDA and not e.is_user_annotation())
    return {"step_ms": start.elapsed_time(end) / steps, "launches_per_step": kernels / n}
