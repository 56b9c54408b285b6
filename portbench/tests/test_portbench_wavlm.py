"""The ``wavlm-mhfa`` cell on the CPU: the yardstick's counts against hand
arithmetic, XLS-R's attention reader on a synthetic trace of the cell, and ``correct`` at a
tiny size: the port agrees with the reference, and each planted fault (no
gate; buckets shifted by one; the bias's sign flipped; no normalisation;
half a batch altered) is not correct."""

from __future__ import annotations

import dataclasses
import time

import pytest
import torch

from audioanalysisdetector_tpu_torch.models import wav2vec2
from portbench.harness.cells import BENCH_DIR, load_cell, metric_reader, read_json
from portbench.harness.report import report
from portbench.harness.trace import TraceSummary
from portbench.tests.conftest import tiny
from portbench.yardstick import wavlm_mhfa as yardstick
from portbench.yardstick.xlsr_aasist import attention_bound

CFG = read_json(BENCH_DIR / "configs" / "wavlm-mhfa.json")
TINY = dict(conv_dim=32, hidden=64, heads=4, ffn=128, layers=2, pos_kernel=16, pos_groups=4, n_samples=16000,
            rel_buckets=32, rel_max_distance=40, mhfa_heads=8, mhfa_compression=16, mhfa_outputs=32)
CELL = "wavlm-mhfa.offline"


def tiny_cell():
    cell = tiny(CELL)
    cell.config.update(TINY)
    return cell


def test_ops_by_hand():
    lengths = [51199, 25599, 12799, 6399, 3199, 1599, 799]
    assert yardstick.frames(CFG) == 799
    conv = 2 * 512 * 10 * 51199 + sum(2 * 512 * 512 * 3 * n for n in lengths[1:5]) \
        + sum(2 * 512 * 512 * 2 * n for n in lengths[5:])
    layer = 799 * (8 * 1024 * 1024 + 4 * 1024 * 4096) + 4 * 799 * 799 * 1024
    pos = 2 * 1024 * 64 * 128 * 799
    gate = 24 * 2 * 16 * 64 * 8 * 799
    mhfa = 4 * 25 * 1024 * 799 + 4 * 1024 * 128 * 799 + 2 * 2 * 128 * 64 * 799 + 2 * 8192 * 256 + 2 * 256 * 2
    assert yardstick.gate_ops(CFG) == gate and yardstick.mhfa_ops(CFG) == mhfa
    total = conv + 2 * 512 * 1024 * 799 + pos + 24 * layer + gate + mhfa
    assert yardstick.score_ops(CFG) == total
    assert total / 1e9 == pytest.approx(638.96, abs=0.005)
    # attention: 9.8% of the operations (62.76 GFLOP an utterance)
    assert 24 * 4 * 799 * 799 * 1024 / total == pytest.approx(0.0982, abs=5e-4)


def test_attention_bound_by_hand():
    b = attention_bound(CFG, 32)
    assert b["ops"] == 4 * 32 * 16 * 799 ** 2 * 64
    assert b["ops"] / 1e9 == pytest.approx(83.68, abs=0.005)
    assert b["bytes"] == 4 * 32 * 799 * 1024 * 4
    # 83.68 GFLOP at 494.7 TFLOP/s against 0.419 GB at 3.35 TB/s
    assert b["by"] == "operations" and b["bound_s"] * 1e3 == pytest.approx(0.1691, abs=5e-5)


def test_attention_reader_on_a_synthetic_trace():
    # the cell reports XLS-R's attention share, and the two span timings
    assert {"xlsr.attention_roofline", "frontend_ms.score", "model_ms.score"} <= {
        m["name"] for m in load_cell(CELL).per_layer}
    read = metric_reader("xlsr.attention_roofline").read
    kernels = {"fmha_cutlassF_f32_aligned_64x64_rf_sm80(AttentionKernel<float, ...>)": [5e-3, 3e-3],
               "sm80_xmma_gemm_f32f32": [5e-3]}
    t = TraceSummary(window_s=1.0, busy_s=0.9, kernels=kernels)
    ctx = {"trace": t, "utterances_per_call": 32, "config": CFG}
    bound = attention_bound(CFG, 32)["bound_s"]
    assert read(ctx) == pytest.approx(100 * bound / 4e-3)
    assert read({**ctx, "trace": TraceSummary(1.0, 0.9, {"sm80_xmma_gemm_f32f32": [5e-3]})}) is None
    assert read({**ctx, "trace": None}) is None


def run(cell, seed: int = 2**31 + 3, seconds: float = 0.3):
    return report(cell, seed=seed, seconds=seconds, trace=False, device="cpu", t_start=time.perf_counter())[0]


def test_port_agrees_with_reference():
    torch.set_num_threads(4)
    result = run(tiny_cell())
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == {"setup_s", "score_utt_per_s"}


def _half_altered(score):
    def altered(wav):
        out = score(wav).clone()
        out[out.shape[0] // 2:] += 0.01
        return out
    return altered


def _plant(name: str, monkeypatch, system) -> None:
    """One fault in the port, or in what the system builds of it."""
    gated = wav2vec2.GatedEncoderLayer.attention_bias
    if name == "no_gate":
        monkeypatch.setattr(wav2vec2.GatedEncoderLayer, "attention_bias", lambda self, x, bias: bias)
    elif name == "buckets_shifted":
        table = wav2vec2.relative_buckets

        def shifted(t, buckets, max_distance, device):
            return (table(t, buckets, max_distance, device) + 1).clamp(max=buckets - 1)
        monkeypatch.setattr(wav2vec2, "relative_buckets", shifted)
    elif name == "bias_sign_flipped":
        monkeypatch.setattr(wav2vec2.GatedEncoderLayer, "attention_bias", lambda self, x, bias: -gated(self, x, bias))
    elif name == "no_normalisation":
        config = system._wavlm_config
        monkeypatch.setattr(system, "_wavlm_config", lambda cfg: dataclasses.replace(config(cfg), normalize=False))
    else:
        build = system.build

        def broken(*a, **k):
            program = build(*a, **k)
            program.score = _half_altered(program.score)
            return program
        monkeypatch.setattr(system, "build", broken)


@pytest.mark.parametrize("fault", ["no_gate", "buckets_shifted", "bias_sign_flipped", "no_normalisation",
                                   "half_altered"])
def test_fault_is_not_correct(fault, monkeypatch):
    torch.set_num_threads(4)
    cell = tiny_cell()
    _plant(fault, monkeypatch, cell.system())
    result = run(cell)
    assert not result["correct"] and result["failed"] > 0
