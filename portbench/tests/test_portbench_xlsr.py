"""The ``xlsr-aasist`` cell on the CPU: the yardstick's counts against hand
arithmetic, the attention reader on a synthetic trace, and ``correct`` at a
tiny size (the port agrees with the reference; half a batch left out, or
one answer altered, is not correct). The reference's top-k rule is tested
with the port, in ``tests/test_torch_xlsr_aasist.py``."""

from __future__ import annotations

import time

import pytest
import torch

from portbench.harness.cells import BENCH_DIR, metric_reader, read_json
from portbench.harness.report import report
from portbench.harness.trace import TraceSummary
from portbench.tests.conftest import tiny
from portbench.yardstick import xlsr_aasist as yardstick

CFG = read_json(BENCH_DIR / "configs" / "xlsr-aasist.json")
TINY = dict(conv_dim=32, hidden=64, heads=4, ffn=128, layers=2, pos_kernel=16, pos_groups=4, n_samples=16000)
CELL = "xlsr-aasist.offline"


def tiny_cell():
    cell = tiny(CELL)
    cell.config.update(TINY)
    return cell


def test_front_end_ops_by_hand():
    lengths = [12919, 6459, 3229, 1614, 806, 403, 201]
    assert yardstick.conv_lengths(CFG) == lengths
    conv = 2 * 512 * 10 * 12919 + sum(2 * 512 * 512 * 3 * n for n in lengths[1:5]) \
        + sum(2 * 512 * 512 * 2 * n for n in lengths[5:])
    layer = 201 * (8 * 1024 * 1024 + 4 * 1024 * 4096) + 4 * 201 * 201 * 1024
    pos = 2 * 1024 * 64 * 128 * 201
    x = yardstick.xlsr_ops(CFG)
    front = x["conv"] + x["proj"] + x["pos_conv"] + x["layers"]
    assert front == conv + 2 * 512 * 1024 * 201 + pos + 24 * layer
    assert front / 1e9 == pytest.approx(148.76, abs=0.005)
    assert x["attention"] / 1e9 == pytest.approx(3.97, abs=0.005)
    assert 0.5e9 < yardstick.aasist_ops(CFG) < 2e9


def test_attention_bound_by_hand():
    b = yardstick.attention_bound(CFG, 128)
    assert b["ops"] == 4 * 128 * 16 * 201 ** 2 * 64
    assert b["ops"] / 1e9 == pytest.approx(21.18, abs=0.005)
    assert b["bytes"] == 4 * 128 * 201 * 1024 * 4
    assert b["bytes"] / 1e6 == pytest.approx(421.5, abs=0.05)
    assert b["by"] == "bytes" and b["bound_s"] * 1e3 == pytest.approx(0.1258, abs=5e-5)


def test_attention_reader_on_a_synthetic_trace():
    read = metric_reader("xlsr.attention_roofline").read
    kernels = {"fmha_cutlassF_f32_aligned_64x64_rf_sm80(AttentionKernel<float, ...>)": [0.5e-3, 0.3e-3],
               "sm90_xmma_gemm_f32f32": [5e-3]}
    t = TraceSummary(window_s=1.0, busy_s=0.9, kernels=kernels)
    ctx = {"trace": t, "utterances_per_call": 128, "config": CFG}
    assert read(ctx) == pytest.approx(100 * 0.12582912e-3 / 0.4e-3)
    assert read({**ctx, "trace": TraceSummary(1.0, 0.9, {"sm90_xmma_gemm_f32f32": [5e-3]})}) is None
    assert read({**ctx, "trace": None}) is None


def run(cell, seed: int = 2**31 + 3, seconds: float = 0.3):
    return report(cell, seed=seed, seconds=seconds, trace=False, device="cpu", t_start=time.perf_counter())[0]


def test_port_agrees_with_reference():
    torch.set_num_threads(4)
    result = run(tiny_cell())
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == {"setup_s", "score_utt_per_s"}


def _half_left_out(scores: torch.Tensor) -> torch.Tensor:
    half = scores.shape[0] // 2
    return torch.cat([scores[:half], scores[:half].mean().expand(scores.shape[0] - half)])


def _one_altered(scores: torch.Tensor) -> torch.Tensor:
    out = scores.clone()
    out[-1] = out[-1] + 0.01
    return out


@pytest.mark.parametrize("fault", [_half_left_out, _one_altered], ids=["half_left_out", "one_altered"])
def test_fault_is_not_correct(fault, monkeypatch):
    torch.set_num_threads(4)
    cell = tiny_cell()
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
