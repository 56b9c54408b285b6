"""``correct`` on the CPU at tiny sizes: the port agrees with the plain
references, and a run whose timed path is broken underneath comes out not
correct, once for each fault the cells can have (half of the batch left
out, an answer altered where it is produced). The look for a card is the
entry point's, which these tests skip: they drive the rest of a run."""

from __future__ import annotations

import time

import pytest
import torch

from portbench.harness.report import report
from portbench.tests.conftest import tiny

OFFLINE = ["mel-parity.offline", "cqcc-fused.offline"]


def run(cell, seed: int = 2**31 + 3, seconds: float = 0.3):
    result, lines = report(cell, seed=seed, seconds=seconds, trace=False, device="cpu",
                           t_start=time.perf_counter())
    assert lines[-len(result["checks"]):] and all(line.startswith("check ") for line in
                                                  lines[-len(result["checks"]):])
    return result


def half_left_out(scores: torch.Tensor) -> torch.Tensor:
    """The first half scored, the second given the first half's mean."""
    half = scores.shape[0] // 2
    return torch.cat([scores[:half], scores[:half].mean().expand(scores.shape[0] - half)])


def one_altered(scores: torch.Tensor) -> torch.Tensor:
    out = scores.clone()
    out[-1] = out[-1] + 0.01
    return out


@pytest.mark.parametrize("name", OFFLINE)
def test_port_agrees_with_reference(name):
    result = run(tiny(name))
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == {"setup_s", "score_utt_per_s"}


@pytest.mark.parametrize("fault", [half_left_out, one_altered], ids=["half_left_out", "one_altered"])
@pytest.mark.parametrize("name", OFFLINE)
def test_offline_fault_is_not_correct(name, fault, monkeypatch):
    cell = tiny(name)
    system = cell.system()
    build = system.build

    def broken(*a, **k):
        program = build(*a, **k)
        score = program.score
        program.score = lambda wav: fault(score(wav))
        return program

    monkeypatch.setattr(system, "build", broken)
    result = run(cell)
    assert not result["correct"] and result["failed"] > 0


def _serve_cell():
    return tiny("mel-parity.serve")


def test_serve_agrees_with_reference():
    result = run(_serve_cell(), seconds=1.0)
    assert result["correct"], result["checks"]
    assert result["attempted"] == 20 and result["failed"] == 0
    assert set(result["metrics"]) == {"setup_s", "serve_p95_ms"}


@pytest.mark.parametrize("fault", [half_left_out, one_altered], ids=["half_left_out", "one_altered"])
def test_serve_fault_is_not_correct(fault, monkeypatch):
    cell = _serve_cell()
    system = cell.system()
    serve_scorer = system.serve_scorer

    def broken(*a, **k):
        scorer, n = serve_scorer(*a, **k)

        def wrong(wav):
            return fault(torch.from_numpy(scorer(wav))).numpy()

        wrong.platform, wrong.row_multiple = scorer.platform, scorer.row_multiple
        return wrong, n

    monkeypatch.setattr(system, "serve_scorer", broken)
    assert not run(cell, seconds=1.0)["correct"]


def test_unanswered_request_is_not_correct(monkeypatch):
    cell = _serve_cell()
    driver = cell.driver()
    collect = driver.collect

    def lossy(procs, seconds):
        results = collect(procs, seconds)
        results[min(results)] = [None, 503, None]
        return results

    monkeypatch.setattr(driver, "collect", lossy)
    result = run(cell, seconds=1.0)
    assert not result["correct"] and result["failed"] == 1
    assert result["metrics"]["serve_p95_ms"]["value"] != "inf"


def _train_cell():
    return tiny("mel-parity.train", utterances=40, batch=8)


def test_train_follows_reference():
    result = run(_train_cell(), seconds=0.5)
    assert result["correct"], result["checks"]
    assert set(result["checks"]) == {"bn_stats_gap", "loss_gap", "change_gap"}
    assert set(result["metrics"]) == {"setup_s", "train_utt_per_s"}


@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch", "altered_token"])
def test_train_fault_is_not_correct(fault):
    from portbench.tools.faults import FAULTS

    with FAULTS[fault]():
        result = run(_train_cell(), seconds=0.5)
    assert not result["correct"], result["checks"]
