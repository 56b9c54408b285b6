"""The port's ``utils/`` (profiling, plotting) against the JAX package's, on the CPU.

``StepTimer.summary`` is pure numpy over the recorded times: given the same
times it is the JAX package's dict exactly. ``measure``, ``profile_fn`` and
``timed`` are checked for their keys and for running the body;
``device_trace`` for a Chrome trace file in its directory. The histogram
plots are held to the JAX package's file names (with matplotlib
installed); without matplotlib the port writes nothing and says so on stderr.
"""

import json
import sys

import numpy as np
import pandas as pd
import pytest
import torch

import audioanalysisdetector_tpu.utils.plotting as jplot
import audioanalysisdetector_tpu.utils.profiling as jprof
from audioanalysisdetector_tpu_torch import utils
from audioanalysisdetector_tpu_torch.utils import plotting, profiling

torch.set_num_threads(2)


@pytest.mark.parametrize("items, skip", [(None, 1), (256, 0), (8, 3)])
def test_step_timer_summary_matches_jax(items, skip, tmp_path):
    times = list(np.random.default_rng(1).uniform(0.001, 0.02, 9))
    ours, ref = profiling.StepTimer("step"), jprof.StepTimer("step")
    for t in times:
        ours.record(t)
        ref.record(t)
    assert ours.summary(items_per_step=items, skip_warmup=skip) == ref.summary(items_per_step=items, skip_warmup=skip)
    ours.dump(str(tmp_path / "a.json"), items_per_step=items)
    ref.dump(str(tmp_path / "b.json"), items_per_step=items)
    assert json.loads((tmp_path / "a.json").read_text()) == json.loads((tmp_path / "b.json").read_text())


def test_measure_profile_fn_timed(capsys):
    timer = utils.StepTimer("mm")
    x = torch.randn(64, 64)
    for _ in range(3):
        with timer.measure() as sync:
            out = sync({"y": [x @ x]})
    assert out["y"][0].shape == (64, 64) and len(timer.times) == 3 and all(t > 0 for t in timer.times)
    s = timer.summary(items_per_step=64)
    assert set(s) == {"name", "steps", "mean_ms", "p50_ms", "p99_ms", "total_s", "items_per_sec"} and s["steps"] == 2
    calls = []
    prof = utils.profile_fn(lambda a: calls.append(1) or a + 1, x, iters=4, warmup=2, items=64)
    assert set(prof) == set(s) and prof["steps"] == 4 and len(calls) == 6
    with utils.timed("phase"):
        pass
    assert capsys.readouterr().out.startswith("phase: ")
    with utils.timed("quiet", verbose=False):
        pass
    assert capsys.readouterr().out == ""


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with utils.device_trace(str(tmp_path / "trace")):
        torch.randn(32, 32) @ torch.randn(32, 32)
    files = list((tmp_path / "trace").glob("trace_*.json"))
    assert len(files) == 1
    assert "traceEvents" in json.loads(files[0].read_text())


def _table(rng):
    return pd.DataFrame({"mfcc": [rng.standard_normal(5) for _ in range(12)] + [None],
                         "label": ["spoof", "bonafide", "spoof"] * 4 + ["spoof"]})


def test_plot_file_names_match_jax(tmp_path):
    df = _table(np.random.default_rng(2))
    want = jplot.plot_coeff_histograms_by_label(df, "mfcc", out_dir=str(tmp_path / "j"), max_coeffs=3)
    got = plotting.plot_coeff_histograms_by_label(df.to_dict("records"), "mfcc", out_dir=str(tmp_path / "t"),
                                                  max_coeffs=3)
    assert [p.split("/")[-1] for p in got] == [p.split("/")[-1] for p in want] == ["mfcc_1.png", "mfcc_2.png",
                                                                                   "mfcc_3.png"]
    assert all((tmp_path / "t" / n).stat().st_size > 0 for n in ("mfcc_1.png", "mfcc_3.png"))
    assert plotting.plot_coeff_histograms_by_label([{"mfcc": None, "label": "x"}], "mfcc",
                                                   out_dir=str(tmp_path / "e")) == []


def test_plot_without_matplotlib_writes_nothing(tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    rows = _table(np.random.default_rng(3)).to_dict("records")
    assert plotting.plot_coeff_histograms_by_label(rows, "mfcc", out_dir=str(tmp_path / "p")) == []
    err = capsys.readouterr().err.strip().splitlines()
    assert len(err) == 1 and "matplotlib" in err[0]
    assert not (tmp_path / "p").exists()


def test_utils_exports_match_jax():
    import audioanalysisdetector_tpu.utils as jutils

    assert sorted(utils.__all__) == sorted(jutils.__all__)
    assert "compile_cache" in utils.__doc__
