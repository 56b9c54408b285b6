"""Tracing / profiling subsystem (PyTorch port).

Counterpart of the JAX package's ``utils/profiling.py``: per-step timing
aggregation with percentile summaries and throughput (``StepTimer``,
``profile_fn``), a phase-scoped wall timer (``timed``) and device trace
capture (``device_trace``, ``torch.profiler`` writing a Chrome trace that
Perfetto or ``chrome://tracing`` opens). Work queued on a card runs
asynchronously, so the timers synchronize on the device of the result
before the clock stops.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch


def _first_tensor(x) -> torch.Tensor | None:
    """The first tensor in ``x`` (a tensor, or nested lists / tuples / dicts)."""
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        for item in x:
            t = _first_tensor(item)
            if t is not None:
                return t
    return None


def sync_on(x) -> None:
    """Wait for the card that holds ``x``'s first tensor (a no-op on the CPU)."""
    t = _first_tensor(x)
    if t is not None and t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


@dataclass
class StepTimer:
    """Accumulates per-step wall times.

    ``measure`` synchronizes on whatever the body passes to ``sync`` before
    the clock stops; without it, card work would be timed at launch cost only.
    """

    name: str = "step"
    times: list[float] = field(default_factory=list)

    @contextlib.contextmanager
    def measure(self):
        """Usage: ``with timer.measure() as sync: out = sync(step(...))``.

        ``sync`` waits for the device of its argument's first tensor (and
        returns the argument), so the device work is inside the span.
        """

        def sync(x):
            sync_on(x)
            return x

        t0 = time.perf_counter()
        yield sync
        self.times.append(time.perf_counter() - t0)

    def record(self, seconds: float) -> None:
        self.times.append(seconds)

    def summary(self, *, items_per_step: int | None = None, skip_warmup: int = 1) -> dict:
        t = np.asarray(self.times[skip_warmup:] or self.times)
        out = {
            "name": self.name,
            "steps": len(t),
            "mean_ms": float(t.mean() * 1e3),
            "p50_ms": float(np.percentile(t, 50) * 1e3),
            "p99_ms": float(np.percentile(t, 99) * 1e3),
            "total_s": float(t.sum()),
        }
        if items_per_step:
            out["items_per_sec"] = float(items_per_step / t.mean())
        return out

    def dump(self, path: str, **kwargs) -> None:
        with open(path, "w") as f:
            json.dump(self.summary(**kwargs), f, indent=2)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the CPU and, where there is a
    card, of CUDA; on exit it is written into ``log_dir`` as a Chrome trace
    (``trace_<pid>_<ns>.json``)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.__enter__()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def profile_fn(fn, *args, iters: int = 10, warmup: int = 2, items: int | None = None) -> dict:
    """Time a device function: warm-up calls excluded (first-use kernel
    builds and allocator growth), each call synchronized on its result's
    device before the clock stops."""

    def _force(x):
        sync_on(x)
        return x

    for _ in range(max(warmup, 1)):
        _force(fn(*args))
    timer = StepTimer(getattr(fn, "__name__", "fn"))
    for _ in range(iters):
        t0 = time.perf_counter()
        _force(fn(*args))
        timer.record(time.perf_counter() - t0)
    return timer.summary(items_per_step=items, skip_warmup=0)


def timed(label: str, verbose: bool = True):
    """Phase-scoped wall timer (the reference's start/end print pattern)."""

    @contextlib.contextmanager
    def ctx():
        t0 = time.time()
        yield
        if verbose:
            print(f"{label}: {time.time() - t0:.2f}s")

    return ctx()
