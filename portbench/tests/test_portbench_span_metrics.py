"""The ``span.*`` readers (``metrics/_span.py``) on fake span readings and
a fake traced window, and their entries in ``BENCHMARK.json``."""

from __future__ import annotations

import pytest
from torch.profiler import ProfilerActivity, profile

from audioanalysisdetector_tpu_torch.utils import profiling
from portbench.harness.cells import ROOT, load_cell, metric_reader, read_json
from portbench.harness.trace import TraceSummary
from portbench.metrics import _span

# reader -> the spans it sums
READERS = {
    "span.frontend_ms.score": ("score.frontend",),
    "span.model_ms.score": ("score.model",),
    "span.lstm_ms.score": ("lstm.layer",),
    "span.cqcc_ms.score": ("cqcc.kernel",),
    "span.attention_ms.score": ("ssl.attend",),
    "span.wavlm_bias_ms.score": ("wavlm.position_bias", "wavlm.gated_bias"),
    "span.w2vbert_relkey_ms.score": ("w2vbert.rel_key",),
    "span.w2vbert_conv_ms.score": ("w2vbert.conv_module",),
}
CALLS = 100  # score.call spans completed in the fake window
ROWS = 8


def _ctx(calls: float = CALLS, trace: bool = True) -> dict:
    """A 10-s traced window of ``calls`` calls of ``ROWS`` utterances."""
    summary = TraceSummary(window_s=10.0, busy_s=9.9, kernels={"k": [0.1]}) if trace else None
    return {"trace": summary, "rate_utt_per_s": calls * ROWS / 10.0, "utterances_per_call": ROWS}


def _readings(calls: int = CALLS) -> dict[str, tuple[float, int]]:
    """Every span of every reader, ``ms`` = 10 × its index + 10 a call."""
    names = sorted({n for spans in READERS.values() for n in spans})
    out = {name: ((10.0 * i + 10.0) * calls, calls * 24) for i, name in enumerate(names)}
    out["score.call"] = (5000.0, calls)
    return out


@pytest.fixture
def readings(monkeypatch):
    """The program's readings replaced by ``_readings()``; the dict is
    returned so a test can change it."""
    fake = _readings()
    monkeypatch.setattr(profiling, "span_readings", lambda: fake)
    return fake


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_gives_ms_per_call_summed_over_its_spans(readings, name):
    want = sum(readings[s][0] for s in READERS[name]) / CALLS
    assert metric_reader(name).read(_ctx()) == pytest.approx(want)


def test_names_are_summed_and_absent_names_left_out(monkeypatch):
    r = {"score.call": (1.0, 4), "a": (8.0, 4), "b": (4.0, 96)}
    monkeypatch.setattr(profiling, "span_readings", lambda: r)
    assert _span.per_call(_ctx(4), ("a", "b")) == pytest.approx(3.0)
    assert _span.per_call(_ctx(4), ("a", "missing")) == pytest.approx(2.0)
    assert _span.per_call(_ctx(4), ("missing",)) is None


@pytest.mark.parametrize("window_calls, found", [(100, True), (101, True), (102, False), (97, False)])
def test_a_call_count_off_by_more_than_one_call_refuses(readings, window_calls, found):
    value = metric_reader("span.model_ms.score").read(_ctx(window_calls))
    assert (value is not None) == found


def test_one_percent_of_a_long_window_is_allowed(monkeypatch):
    r = _readings(5000)
    monkeypatch.setattr(profiling, "span_readings", lambda: r)
    assert _span.per_call(_ctx(5049), ("score.model",)) is not None
    assert _span.per_call(_ctx(5051), ("score.model",)) is None


def test_no_trace_no_calls_or_no_readings_gives_none(readings, monkeypatch):
    reader = metric_reader("span.frontend_ms.score")
    assert reader.read(_ctx(trace=False)) is None
    assert reader.read({**_ctx(), "trace": TraceSummary(window_s=10.0, busy_s=0.0)}) is None
    assert reader.read({**_ctx(), "rate_utt_per_s": None}) is None
    del readings["score.call"]
    assert reader.read(_ctx()) is None
    monkeypatch.setattr(profiling, "span_readings", lambda: {})
    assert reader.read(_ctx()) is None
    monkeypatch.delattr(profiling, "span_readings")  # a port that takes no readings
    assert reader.read(_ctx()) is None


def test_the_program_readings_are_read_in_process():
    profiling.reset_span_readings()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            with profiling.span("score.call"):
                with profiling.span("score.model"):
                    pass
    r = _span.program_readings()
    assert r["score.call"][1] == r["score.model"][1] == 3
    assert _span.per_call(_ctx(3), ("score.model",)) == pytest.approx(r["score.model"][0] / 3)
    profiling.reset_span_readings()


def test_entries_name_existing_cells_and_their_readers():
    bench = read_json(ROOT / "BENCHMARK.json")
    cells = {w["name"] for w in bench["workloads"]}
    entries = {m["name"]: m for m in bench["per_layer"] if m["name"].startswith("span.")}
    assert set(entries) == set(READERS)
    for name, m in entries.items():
        assert m["source"] == "program_span" and m["moves"] == "score_utt_per_s" and m["unit"] == "ms"
        assert m["workloads"] and set(m["workloads"]) <= cells, name
        for cell in m["workloads"]:
            assert name in [p["name"] for p in load_cell(cell).per_layer], (name, cell)
