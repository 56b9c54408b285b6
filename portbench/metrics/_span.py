"""Device ms a call from the program's own span readings, shared by the
``span.*`` readers.

While a profiler records, the port's ``utils/profiling.py::span`` stamps
the current stream on open and on close and sums the time between the
stamps by span name; ``span_readings()`` returns ``{name: (ms,
completions)}``. In a ``--trace 1`` run only the window is profiled (the
warm-ups, the after-window ``frontend_ms``/``model_ms`` calls and the
reference run with no profiler), so the readings hold the window's spans.
``per_call`` sums the readings of ``names`` and divides by the completed
``score.call`` spans. It gives None with no trace, where the program has
no readings (a port without ``span_readings``) or none of ``names``, and
where the ``score.call`` completions differ from the window's calls
(``rate_utt_per_s × window_s / utterances_per_call``) by more than
max(1, 1%): a wrong attribution does not become a number."""

from __future__ import annotations

CALL_SPAN = "score.call"
CALLS_TOLERANCE = 0.01  # of the window's calls, and at least one call


def program_readings() -> dict[str, tuple[float, int]] | None:
    """The port's span readings, or None where it takes none."""
    try:
        from audioanalysisdetector_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "span_readings", None)
    return read() if read is not None else None


def per_call(ctx: dict, names: tuple[str, ...]) -> float | None:
    """Milliseconds a completed ``score.call`` under the spans ``names``, summed."""
    t, rate, rows = ctx.get("trace"), ctx.get("rate_utt_per_s"), ctx.get("utterances_per_call")
    if t is None or not t.kernels or t.window_s <= 0 or rate is None or not rows:
        return None
    readings = program_readings()
    if not readings:
        return None
    calls = readings.get(CALL_SPAN, (0.0, 0))[1]
    window_calls = rate * t.window_s / rows
    if not calls or abs(calls - window_calls) > max(1.0, CALLS_TOLERANCE * window_calls):
        return None
    found = [readings[n][0] for n in names if n in readings]
    return sum(found) / calls if found else None
