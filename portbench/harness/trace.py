"""The device trace of a traced run's window, and what it says.

``Window`` wraps the measured window in ``torch.profiler`` (CPU and CUDA
activities) with a ``record_function`` range around it. ``summarize``
reads the profiler's events once: the union of the intervals in which an
operation (kernel, copy, fill) ran on the device, clipped to that range,
is ``busy_s``; the range is ``window_s``. Time is the union, not the sum,
so work on concurrent streams is not counted twice and the busy share
cannot pass 1. The breakdown lists the device operations that took most
time and the longest gaps between them, each named by the host operation
that covered most of it.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

WINDOW_RANGE = "portbench.window"


def union_length(intervals: list[tuple[float, float]]) -> float:
    """Total length covered by ``[start, end)`` intervals (overlaps once)."""
    total = 0.0
    cur_s = cur_e = None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals: list[tuple[float, float]], lo: float, hi: float) -> list[tuple[float, float]]:
    """The stretches of ``[lo, hi)`` that no interval covers."""
    out = []
    cur = lo
    for s, e in sorted(intervals):
        if s > cur:
            out.append((cur, min(s, hi)))
        cur = max(cur, e)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(s, e) for s, e in out if e > s]


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernels: dict[str, list[float]] = field(default_factory=dict)  # name -> durations (s)
    device_ops: list[list] = field(default_factory=list)
    idle_gaps: list[list] = field(default_factory=list)

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s


def summarize(events, top: int = 10) -> TraceSummary | None:
    """``events``: ``(name, on_device, start_s, end_s)`` tuples of one trace.
    None when the trace holds no window range."""
    window = [(s, e) for name, dev, s, e in events if not dev and name == WINDOW_RANGE]
    if not window:
        return None
    # the host range itself; a mirror of it on another timeline is shorter
    lo, hi = max(window, key=lambda w: w[1] - w[0])
    device = [(name, max(s, lo), min(e, hi)) for name, dev, s, e in events
              if dev and name != WINDOW_RANGE and e > lo and s < hi]
    busy = union_length([(s, e) for _, s, e in device])
    kernels: dict[str, list[float]] = {}
    for name, s, e in device:
        kernels.setdefault(name, []).append(e - s)
    ranked = sorted(((sum(d), name) for name, d in kernels.items()), reverse=True)[:top]
    host = [(name, s, e) for name, dev, s, e in events
            if not dev and name != WINDOW_RANGE and e > lo and s < hi]
    idle = sorted(gaps([(s, e) for _, s, e in device], lo, hi), key=lambda g: g[0] - g[1])[:top]
    named = []
    for s, e in idle:
        best, name = 0.0, "no host operation traced"
        for h_name, h_s, h_e in host:
            cover = min(e, h_e) - max(s, h_s)
            if cover > best:
                best, name = cover, h_name
        named.append([name, e - s])
    return TraceSummary(window_s=hi - lo, busy_s=busy, kernels=kernels,
                        device_ops=[[name, t] for t, name in ranked], idle_gaps=named)


def prepare(on: bool, device: str) -> None:
    """Open and close one empty profiler session, when ``on``. A process's
    first session, begun after it started a child process, keeps a window
    range that ends almost at once; call this before starting any."""
    if on:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if str(device).startswith("cuda") else [])
        with profile(activities=acts):
            pass


class Window:
    """``with Window(on, device) as w: ...`` traces the block when ``on``;
    ``w.summary`` is then its ``TraceSummary`` (None when off)."""

    def __init__(self, on: bool, device: str):
        self.on = on
        self.cuda = str(device).startswith("cuda")
        self.summary: TraceSummary | None = None
        self._stack = contextlib.ExitStack()

    def __enter__(self) -> "Window":
        if self.on:
            from torch.profiler import ProfilerActivity, profile, record_function

            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
            self._prof = self._stack.enter_context(profile(activities=acts))
            self._stack.enter_context(record_function(WINDOW_RANGE))
        return self

    def __exit__(self, *exc) -> None:
        self._stack.close()
        if self.on and exc[0] is None:
            self.summary = summarize(list(_events(self._prof)))


def _events(prof):
    """``(name, on_device, start_s, end_s)`` of every event the profiler
    kept, from kineto's raw events (cheaper than ``prof.events()``)."""
    from torch.autograd import DeviceType

    for e in prof.profiler.kineto_results.events():
        on_device = e.device_type() == DeviceType.CUDA
        if on_device and e.is_user_annotation():
            continue  # a host range mirrored on the device timeline: no work
        start = e.start_ns() * 1e-9
        yield e.name(), on_device, start, start + e.duration_ns() * 1e-9
