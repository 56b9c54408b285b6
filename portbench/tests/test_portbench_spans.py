"""Device time by span (``harness/spans.py``) on hand-made event lists."""

from __future__ import annotations

import pytest

from portbench.harness.spans import ANNOTATION, LAUNCH, Event, attribute, per_call, summarize_spans, window_share
from portbench.harness.trace import WINDOW_RANGE, summarize


def span(name, start, end, thread=1):
    return Event(name, False, start, end, ANNOTATION, thread)


def launch(correlation, t, thread=1):
    return Event("cudaLaunchKernel", False, t, t + 0.01, LAUNCH, thread, correlation)


def op(name, start, end, correlation):
    return Event(name, True, start, end, "device", 0, correlation, linked=1000 + correlation)


WINDOW = span(WINDOW_RANGE, 0.0, 10.0)


def one_call(t0=1.0, thread=1):
    """One ``score.call`` of 4 s: frontend (its pad, then K3), then the model."""
    return [span("score.call", t0, t0 + 4.0, thread), span("score.frontend", t0, t0 + 2.0, thread),
            span("mel.pad", t0, t0 + 0.5, thread),
            launch(1, t0 + 0.2, thread), op("pad_kernel", t0 + 0.3, t0 + 0.8, 1),
            launch(2, t0 + 1.0, thread), op("ct_mel_kernel", t0 + 1.0, t0 + 2.5, 2),
            span("score.model", t0 + 2.0, t0 + 4.0, thread),
            launch(3, t0 + 2.1, thread), op("lstm", t0 + 2.5, t0 + 4.5, 3)]


def test_each_operation_goes_to_the_innermost_span_of_its_launch():
    t = attribute([WINDOW] + one_call())
    assert t.calls == {"score.call": 1, "score.frontend": 1, "mel.pad": 1, "score.model": 1}
    assert t.device_s["mel.pad"] == pytest.approx(0.5)
    assert t.device_s["score.frontend"] == pytest.approx(0.5 + 1.5)  # the pad is under the frontend too
    assert t.device_s["score.model"] == pytest.approx(2.0)  # runs past its host span: its launch decides
    assert t.device_s["score.call"] == pytest.approx(4.0) and t.launches["score.call"] == 3
    assert t.busy_s == pytest.approx(4.0) and t.unattributed_s == 0.0
    assert per_call(t, "score.frontend") == pytest.approx(2000.0)
    assert per_call(t, "score.call", launches=True) == 3


def test_the_launching_thread_decides_not_the_time_alone():
    # thread 2 holds a span over the whole call; the launches are thread 1's
    events = [WINDOW, span("serve.parse", 0.5, 6.0, thread=2)] + one_call()
    t = attribute(events)
    assert "serve.parse" not in t.device_s and t.device_s["score.model"] == pytest.approx(2.0)
    moved = [WINDOW, span("serve.dispatch", 0.5, 6.0, thread=2), launch(9, 1.0, thread=2),
             op("k", 1.0, 2.0, 9)] + one_call()
    assert attribute(moved).device_s["serve.dispatch"] == pytest.approx(1.0)


def test_a_launch_outside_torch_ops_goes_to_the_one_thread_with_a_span_open():
    # K3's launch from a worker thread: no torch op (linked 0), filed under thread 1
    k3 = Event("ct_mel_kernel", True, 2.0, 3.0, "device", 0, 5, 0)
    events = [WINDOW, span("serve.dispatch", 1.0, 4.0, thread=2), launch(5, 1.5, thread=1), k3]
    assert attribute(events).device_s == {"serve.dispatch": pytest.approx(1.0)}
    both = events + [span("serve.parse", 1.0, 2.0, thread=3)]  # two threads hold a span: no guess
    t = attribute(both)
    assert t.device_s == {} and t.unattributed_s == pytest.approx(1.0)
    torch_op = events[:3] + [Event("k", True, 2.0, 3.0, "device", 0, 5, 77)]  # a torch op's launch: its thread
    assert attribute(torch_op).unattributed_s == pytest.approx(1.0)


def test_union_within_a_span_counts_overlap_once():
    events = [WINDOW, span("score.call", 1.0, 3.0), launch(1, 1.1), launch(2, 1.2),
              op("a", 1.5, 2.5, 1), op("b", 2.0, 3.0, 2),  # two streams
              op("c", 9.5, 11.0, 2)]  # runs past the window: clipped
    t = attribute(events)
    assert t.device_s["score.call"] == pytest.approx(1.5 + 0.5) and t.launches["score.call"] == 3
    assert t.busy_s == pytest.approx(2.0)


def test_unattributed_share_refuses_the_readings():
    call = one_call()
    stray = [launch(7, 6.0), op("stray", 6.0, 6.03, 7), op("no_launch", 7.0, 7.001, 99)]  # under no span
    t = attribute([WINDOW] + call + stray)
    assert t.unattributed_s == pytest.approx(0.031)
    assert t.unattributed_s < 0.01 * t.busy_s and per_call(t, "score.model") == pytest.approx(2000.0)
    t = attribute([WINDOW] + call + stray + [launch(8, 8.0), op("more", 8.0, 8.01, 8)])
    assert t.unattributed_s > 0.01 * t.busy_s
    assert per_call(t, "score.model") is None and per_call(t, "score.call", launches=True) is None


def test_no_completed_call_no_reading():
    t = attribute([WINDOW] + one_call(t0=8.0))  # the call ends after the window
    assert "score.call" not in t.calls and per_call(t, "score.frontend") is None
    assert attribute(one_call()) is None and per_call(None, "score.model") is None


def test_summarize_spans_is_summarize_without_spans():
    events = [WINDOW, Event("aten::pad", False, 0.5, 2.0, "cpu_op", 1), launch(1, 1.9),
              op("k1", 2.0, 6.0, 1), op("k2", 1.0, 3.0, 0), Event("cudaDeviceSynchronize", False, 6.0, 9.0,
                                                                  LAUNCH, 1)]
    plain = summarize([(e.name, e.on_device, e.start, e.end) for e in events])
    assert summarize_spans(events) == plain
    assert summarize_spans(one_call()) is None


def test_gaps_are_named_by_span_path():
    events = [WINDOW, span("score.call", 1.0, 5.0), span("score.frontend", 1.0, 3.0), span("mel.pad", 1.0, 2.5),
              Event("aten::pad", False, 1.2, 2.4, "cpu_op", 1), launch(1, 2.4), op("k3", 2.5, 4.0, 1),
              Event("aten::lstm", False, 6.0, 9.0, "cpu_op", 1), op("lstm", 9.0, 10.0, 0)]
    t = summarize_spans(events)
    plain = summarize([(e.name, e.on_device, e.start, e.end) for e in events])
    assert [g[1] for g in t.idle_gaps] == [g[1] for g in plain.idle_gaps]
    assert [g[0] for g in plain.idle_gaps] == ["aten::lstm", "score.call"]  # a span wins the contest today
    assert [g[0] for g in t.idle_gaps] == ["aten::lstm", "score.call/score.frontend/mel.pad: aten::pad"]
    assert t.busy_s == plain.busy_s and t.device_ops == plain.device_ops


def test_window_share_of_validation_and_checkpoints():
    events = [WINDOW, span("fit.epoch", 0.0, 8.0), span("fit.validate", 5.0, 7.0), span("fit.checkpoint", 6.5, 7.5),
              span("fit.step", 1.0, 2.0)]
    assert window_share(events, ("fit.validate", "fit.checkpoint")) == pytest.approx(0.25)
    assert window_share(events[1:], ("fit.validate",)) is None
