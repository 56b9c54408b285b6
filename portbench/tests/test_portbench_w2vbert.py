"""The ``w2vbert-mhfa`` cell on the CPU: the yardstick's counts and the
attention's bound against hand arithmetic, the cell's attention reader on a
synthetic trace, and ``correct`` at a tiny size: the port agrees with the
reference, and each planted fault (the relative window reversed; the
depthwise pad centred; the macaron halves made whole; no per-frame mean
removal; frame pairs interleaved; half a batch altered) is not correct."""

from __future__ import annotations

import time

import pytest
import torch

from audioanalysisdetector_tpu_torch.frontend import fbank as fb
from audioanalysisdetector_tpu_torch.models import w2v_bert
from portbench.harness.cells import BENCH_DIR, load_cell, metric_reader, read_json
from portbench.harness.report import report
from portbench.harness.trace import TraceSummary
from portbench.tests.conftest import tiny
from portbench.yardstick import w2vbert_mhfa as yardstick

CFG = read_json(BENCH_DIR / "configs" / "w2vbert-mhfa.json")
TINY = dict(hidden=64, heads=4, ffn=128, layers=2, n_samples=16000, mhfa_heads=8, mhfa_compression=16,
            mhfa_outputs=32)
CELL = "w2vbert-mhfa.offline"


def tiny_cell():
    cell = tiny(CELL)
    cell.config.update(TINY)
    return cell


def test_ops_by_hand():
    t = 799
    assert yardstick.frames(CFG) == t and (1 + (256000 - 400) // 160) == 1598
    d, f = 1024, 4096
    per_frame = 2 * 4 * d * f + 8 * d * d + 6 * d * d + 2 * d * 31  # two FFNs, q k v out, pointwise, depthwise
    layer = t * per_frame + 4 * t * t * d + 2 * t * 73 * d  # then Q K^T, A V and q E^T
    assert yardstick.layer_ops(CFG)["pointwise"] / t == 6 * d * d == 6_291_456
    mhfa = 4 * 25 * d * t + 4 * d * 128 * t + 2 * 2 * 128 * 64 * t + 2 * 8192 * 256 + 2 * 256 * 2
    assert yardstick.mhfa_ops(CFG) == mhfa
    total = yardstick.fbank_ops(CFG) + 2 * 160 * d * t + 24 * layer + mhfa
    assert yardstick.score_ops(CFG) == pytest.approx(total, rel=1e-12)
    assert total / 1e9 == pytest.approx(992.60, abs=0.005)
    # the second FFN alone 32%, Q K^T and A V 6.3%, q E^T 0.29%
    assert 24 * t * 4 * d * f / total == pytest.approx(0.3241, abs=5e-4)
    assert 24 * 4 * t * t * d / total == pytest.approx(0.0632, abs=5e-4)
    assert 24 * 2 * t * 73 * d / total == pytest.approx(0.00289, abs=5e-5)


def test_fbank_ops_count_the_fft_and_the_filters():
    from portbench.reference.w2vbert_mhfa import _fbank_operands

    filters = _fbank_operands(400, 512, 80, 16000, 20.0, 8000.0, 0.85)[3]
    nnz = int((filters != 0).sum())
    assert 300 < nnz < 600  # 80 triangles over 257 bins, neighbours overlapping
    assert yardstick.fbank_ops(CFG) == 1598 * (2.5 * 512 * 9 + 2 * nnz)


def test_attention_bound_by_hand():
    b = yardstick.attention_bound(CFG, 32)
    assert b["ops"] == 4 * 32 * 16 * 799 ** 2 * 64 + 2 * 32 * 16 * 799 * 73 * 64
    assert b["ops"] / 1e9 == pytest.approx(87.499, abs=0.001)
    assert b["bytes"] == 4 * (4 * 32 * 799 * 1024 + 32 * 16 * 799 * 73)
    # 87.50 GFLOP at 494.7 TFLOP/s against 0.538 GB at 3.35 TB/s
    assert b["by"] == "operations" and b["bound_s"] * 1e3 == pytest.approx(0.17687, abs=5e-5)


def test_attention_reader_on_a_synthetic_trace():
    assert {"w2vbert.attention_roofline", "mfu.score", "frontend_ms.score", "model_ms.score", "idle.score"} <= {
        m["name"] for m in load_cell(CELL).per_layer}
    assert "xlsr.attention_roofline" not in {m["name"] for m in load_cell(CELL).per_layer}
    read = metric_reader("w2vbert.attention_roofline").read
    kernels = {"fmha_cutlassF_f32_aligned_64x64_rf_sm80(AttentionKernel<float, ...>)": [5e-3, 3e-3],
               "sm80_xmma_gemm_f32f32": [5e-3]}
    t = TraceSummary(window_s=1.0, busy_s=0.9, kernels=kernels)
    ctx = {"trace": t, "utterances_per_call": 32, "config": CFG}
    bound = yardstick.attention_bound(CFG, 32)["bound_s"]
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


def _frames_with_their_mean(wav, cfg, window):
    frames = (wav * cfg.sample_scale).unfold(-1, cfg.frame_length, cfg.hop_length)
    frames = torch.cat([frames[..., :1] * (1.0 - cfg.preemphasis),
                        frames[..., 1:] - cfg.preemphasis * frames[..., :-1]], dim=-1)
    return frames * window


def _plant(name: str, monkeypatch, system) -> None:
    """One fault in the port, or in what the system builds of it."""
    if name == "window_reversed":
        index = w2v_bert.relative_key_index
        monkeypatch.setattr(w2v_bert, "relative_key_index",
                            lambda t, left, right, device: index(t, left, right, device).T)
    elif name == "pad_centred":
        pad = torch.nn.functional.pad
        monkeypatch.setattr(torch.nn.functional, "pad",
                            lambda x, p, *a, **k: pad(x, (15, 15) if tuple(p) == (30, 0) else p, *a, **k))
    elif name == "macaron_whole":
        ffn = w2v_bert.FeedForward.forward
        monkeypatch.setattr(w2v_bert.FeedForward, "forward", lambda self, x: 2.0 * ffn(self, x))
    elif name == "no_frame_mean":
        monkeypatch.setattr(fb, "windowed_frames", _frames_with_their_mean)
    elif name == "pairs_interleaved":
        stacked = w2v_bert.kaldi_fbank

        def interleaved(wav, cfg):
            out = stacked(wav, cfg)
            b, t, c = out.shape
            return out.view(b, t, cfg.stride, c // cfg.stride).transpose(-1, -2).reshape(b, t, c)
        monkeypatch.setattr(w2v_bert, "kaldi_fbank", interleaved)
    else:
        build = system.build

        def broken(*a, **k):
            program = build(*a, **k)
            program.score = _half_altered(program.score)
            return program
        monkeypatch.setattr(system, "build", broken)


@pytest.mark.parametrize("fault", ["window_reversed", "pad_centred", "macaron_whole", "no_frame_mean",
                                   "pairs_interleaved", "half_altered"])
def test_fault_is_not_correct(fault, monkeypatch):
    torch.set_num_threads(4)
    cell = tiny_cell()
    _plant(fault, monkeypatch, cell.system())
    result = run(cell)
    assert not result["correct"] and result["failed"] > 0
