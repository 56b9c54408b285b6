"""Device time by the program's spans, read from a traced window's events.

The port opens its spans with ``utils/profiling.py::span``: a
``record_function`` range while a profiler records, on kineto's host
clock beside the launches of the kernels. ``records`` reads a profiler's
events with what the attribution needs (thread, correlation ids, kind: a
host event named ``cu...`` is a CUDA runtime or driver call, a launch).

``attribute`` maps each device operation of the window (clipped to it, as
``trace.summarize`` clips) to its launch, the CUDA call with the same
CUPTI ``correlation`` id, and the launch to the spans open on the launch's
thread at the launch time. An operation's ``linked`` id names the torch
op around its launch; a kernel launched from a C library (K1, K2, K3) has
none, and kineto then files its launch under the thread that read the
trace: such a launch goes to the spans of the one thread with a span open
at its time, and to none where two threads have. Per span name it
gives the device time under the span (the union of its operations'
intervals, nested spans included), the launches, and the spans of that
name completed inside the window. Device time under no span, or with no
launch found, is ``unattributed_s``. ``per_call`` divides by the
completed ``score.call`` spans and gives nothing where no call completed
or where more than 1% of the busy time is unattributed: a wrong
attribution does not become a number.

``summarize_spans`` is ``trace.summarize`` with one change: host user
annotations (the spans) leave the contest for naming an idle gap, and the
gap's name is ``<span path>: <host op>``, the path of the spans open on
the host op's thread where the op meets the gap (``score.call/
score.frontend/mel.pad: aten::pad``), or the op's name alone under no
span. On events holding no span it returns what ``summarize`` returns.
"""

from __future__ import annotations

from bisect import bisect_right
from dataclasses import dataclass, field

from portbench.harness.trace import WINDOW_RANGE, gaps, summarize, union_length

ANNOTATION = "user_annotation"
LAUNCH = "launch"
CALL_SPAN = "score.call"
UNATTRIBUTED_LIMIT = 0.01  # of busy_s


@dataclass(frozen=True)
class Event:
    name: str
    on_device: bool
    start: float  # s
    end: float
    kind: str = ""  # user_annotation (a span), launch (a CUDA runtime or driver call), cpu_op, device
    thread: int = 0
    correlation: int = 0  # CUPTI's: a device operation's and its launch's are the same
    linked: int = 0  # a device operation's torch op, if any


@dataclass
class SpanTimes:
    busy_s: float
    unattributed_s: float
    device_s: dict[str, float] = field(default_factory=dict)  # span name -> union of its operations
    launches: dict[str, int] = field(default_factory=dict)  # span name -> device operations under it
    calls: dict[str, int] = field(default_factory=dict)  # span name -> spans completed in the window


def records(prof) -> list[Event]:
    """Every event a finished ``torch.profiler.profile`` kept but the host
    ranges mirrored on the device timeline (they do no work). The kind is
    read from the event's name and place: torch 2.11's events carry no
    activity type, and a torch op's correlation id may equal a CUDA call's."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        on_device = e.device_type() == DeviceType.CUDA
        if on_device and e.is_user_annotation():
            continue
        name = e.name()
        if on_device:
            kind = "device"
        elif e.is_user_annotation():
            kind = ANNOTATION
        else:
            kind = LAUNCH if name.startswith("cu") else "cpu_op"
        start = e.start_ns() * 1e-9
        out.append(Event(name, on_device, start, start + e.duration_ns() * 1e-9, kind,
                         e.start_thread_id(), e.correlation_id(), e.linked_correlation_id()))
    return out


def window_range(events: list[Event]) -> tuple[float, float] | None:
    """(start, end) of the window range, or None."""
    ranges = [(e.start, e.end) for e in events if not e.on_device and e.name == WINDOW_RANGE]
    return max(ranges, key=lambda w: w[1] - w[0]) if ranges else None


class _Nest:
    """The spans of one thread, nested as ``record_function`` nests them:
    the innermost span open at ``t`` is the last span begun by ``t`` or one
    of its parents."""

    def __init__(self, spans: list[Event]):
        self.spans = sorted(spans, key=lambda s: (s.start, -s.end))
        self.starts = [s.start for s in self.spans]
        self.parent: list[int] = []
        stack: list[int] = []
        for i, s in enumerate(self.spans):
            while stack and self.spans[stack[-1]].end <= s.start:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)

    def path(self, t: float) -> tuple[str, ...]:
        """Names of the spans open at ``t``, outermost first."""
        i = bisect_right(self.starts, t) - 1
        while i >= 0 and self.spans[i].end <= t:
            i = self.parent[i]
        names = []
        while i >= 0:
            names.append(self.spans[i].name)
            i = self.parent[i]
        return tuple(reversed(names))


def _spans_by_thread(events: list[Event]) -> dict[int, _Nest]:
    by: dict[int, list[Event]] = {}
    for e in events:
        if not e.on_device and e.kind == ANNOTATION and e.name != WINDOW_RANGE:
            by.setdefault(e.thread, []).append(e)
    return {thread: _Nest(spans) for thread, spans in by.items()}


def _path(nests: dict[int, _Nest], thread: int, t: float) -> tuple[str, ...]:
    nest = nests.get(thread)
    return nest.path(t) if nest is not None else ()


def attribute(events: list[Event]) -> SpanTimes | None:
    """Device time, launches and completed calls by span name over the
    window; None when the events hold no window range."""
    window = window_range(events)
    if window is None:
        return None
    lo, hi = window
    spans = _spans_by_thread(events)
    launch = {e.correlation: e for e in events if not e.on_device and e.kind == LAUNCH}
    under: dict[str, list[tuple[float, float]]] = {}
    unattributed, busy = [], []
    for e in events:
        if not e.on_device or e.end <= lo or e.start >= hi:
            continue
        iv = (max(e.start, lo), min(e.end, hi))
        busy.append(iv)
        by = launch.get(e.correlation)
        path = _path(spans, by.thread, by.start) if by is not None else ()
        if by is not None and not path and not e.linked:
            # launched outside any torch op (K1, K2, K3 from their C
            # libraries): kineto gives such a launch the thread that read
            # the trace, so take the one thread with a span open then
            open_paths = {p for p in (n.path(by.start) for n in spans.values()) if p}
            path = open_paths.pop() if len(open_paths) == 1 else ()
        for name in set(path):
            under.setdefault(name, []).append(iv)
        if not path:
            unattributed.append(iv)
    calls: dict[str, int] = {}
    for nest in spans.values():
        for s in nest.spans:
            if lo <= s.start and s.end <= hi:
                calls[s.name] = calls.get(s.name, 0) + 1
    return SpanTimes(busy_s=union_length(busy), unattributed_s=union_length(unattributed),
                     device_s={k: union_length(v) for k, v in under.items()},
                     launches={k: len(v) for k, v in under.items()}, calls=calls)


def per_call(times: SpanTimes | None, name: str, *, launches: bool = False) -> float | None:
    """Device ms under ``name`` (or its launches) per completed
    ``score.call``; None without a completed call or when more than 1% of
    the busy time is unattributed."""
    if times is None or not times.calls.get(CALL_SPAN):
        return None
    if times.unattributed_s > UNATTRIBUTED_LIMIT * times.busy_s:
        return None
    n = times.calls[CALL_SPAN]
    if launches:
        return times.launches.get(name, 0) / n
    return 1e3 * times.device_s.get(name, 0.0) / n


def window_share(events: list[Event], names: tuple[str, ...]) -> float | None:
    """Share of the window's host time under any span of ``names`` (the
    union over threads): ``fit.validate`` and ``fit.checkpoint`` of a
    training window."""
    window = window_range(events)
    if window is None:
        return None
    lo, hi = window
    covered = [(max(e.start, lo), min(e.end, hi)) for e in events
               if not e.on_device and e.kind == ANNOTATION and e.name in names and e.end > lo and e.start < hi]
    return union_length(covered) / (hi - lo)


def summarize_spans(events: list[Event], top: int = 10):
    """``trace.summarize`` of ``events`` with the spans out of the gap
    contest and each gap named ``<span path>: <host op>``."""
    plain = [e for e in events if e.on_device or e.kind != ANNOTATION or e.name == WINDOW_RANGE]
    summary = summarize([(e.name, e.on_device, e.start, e.end) for e in plain], top)
    if summary is None:
        return None
    lo, hi = window_range(events)
    spans = _spans_by_thread(events)
    device = [(max(e.start, lo), min(e.end, hi)) for e in plain
              if e.on_device and e.name != WINDOW_RANGE and e.end > lo and e.start < hi]
    host = [e for e in plain if not e.on_device and e.name != WINDOW_RANGE and e.end > lo and e.start < hi]
    idle = sorted(gaps(device, lo, hi), key=lambda g: g[0] - g[1])[:top]
    for row, (s, e) in zip(summary.idle_gaps, idle):
        best, op = 0.0, None
        for h in host:  # summarize's contest: the first op that covers most of the gap
            cover = min(e, h.end) - max(s, h.start)
            if cover > best:
                best, op = cover, h
        path = _path(spans, op.thread, max(s, op.start)) if op is not None else ()
        if path:
            row[0] = f"{'/'.join(path)}: {row[0]}"
    return summary
