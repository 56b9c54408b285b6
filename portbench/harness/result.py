"""What a driver hands back, and the one line a run prints.

A driver returns an ``Outcome``: set-up time, end-to-end values, the
traced window's summary and the context the per-layer readers read, the
counts, and each number compared beside its limit. ``line`` turns it into
the result object; the comparisons come last in it, under ``checks``.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field

import torch


def sync(device) -> None:
    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


def device_ms(fn, device, iters: int = 20) -> float:
    """Milliseconds per call of ``fn`` after two warm calls: CUDA events
    over ``iters`` calls on the card, the host clock elsewhere."""
    for _ in range(2):
        fn()
    sync(device)
    if str(device).startswith("cuda"):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


@dataclass
class Outcome:
    setup_s: float
    attempted: int = 0
    failed: int = 0
    end_to_end: dict[str, float] = field(default_factory=dict)
    memory_peak_bytes: int = 0
    trace: object = None  # harness.trace.TraceSummary of a traced run
    context: dict = field(default_factory=dict)  # what the per-layer readers read
    checks: list[tuple[str, float, float]] = field(default_factory=list)  # (name, value, limit)

    def note_memory(self, device) -> None:
        """The peak of device memory so far: read before the reference runs."""
        if str(device).startswith("cuda"):
            self.memory_peak_bytes = int(torch.cuda.max_memory_allocated())

    def check(self, name: str, value: float, limit: float) -> None:
        """A number held to ``value <= limit``."""
        self.checks.append((name, float(value), float(limit)))

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(math.isfinite(v) and v <= lim for _, v, lim in self.checks)


def _num(x: float) -> float | str:
    """JSON has no infinity: an infinite value is written as a string."""
    return x if math.isfinite(x) else "inf"


def line(out: Outcome, metrics: dict[str, tuple[float, str]], device_info: dict, breakdown: dict | None) -> dict:
    """The result object, ``checks`` last."""
    result = {
        "correct": out.correct,
        "attempted": int(out.attempted),
        "failed": int(out.failed),
        "metrics": {k: {"value": _num(v), "unit": u} for k, (v, u) in metrics.items()},
        "device": device_info,
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {name: {"value": _num(v), "limit": lim} for name, v, lim in out.checks}
    return result
