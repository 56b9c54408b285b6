"""The ``whisper-mhfa`` cell on the CPU: the yardstick's counts and the
attention's and K1's bounds against hand arithmetic, the cell's readers on
a synthetic trace, and ``correct`` at a tiny size: the port agrees with the
reference, and each planted fault (positions omitted; a batch-wide max in
the log-mel's clip; the 3,001st frame kept in place of the first;
tanh-approximated GELU; the last state taken before the final LayerNorm;
half a batch altered) is not correct. A bias on ``k`` is planted too: the
softmax cancels it, so it is correct, as the mathematics says."""

from __future__ import annotations

import time

import pytest
import torch

from audioanalysisdetector_tpu_torch.frontend import mel as mel_mod
from audioanalysisdetector_tpu_torch.frontend.db import power_to_db
from audioanalysisdetector_tpu_torch.models import whisper
from audioanalysisdetector_tpu_torch.utils import profiling
from portbench.harness.cells import BENCH_DIR, ROOT, load_cell, metric_reader, read_json
from portbench.harness.report import report
from portbench.harness.trace import TraceSummary
from portbench.tests.conftest import tiny
from portbench.yardstick import counts
from portbench.yardstick import whisper_mhfa as yardstick

CFG = read_json(BENCH_DIR / "configs" / "whisper-mhfa.json")
TINY = dict(hidden=64, heads=4, ffn=128, layers=2, n_mels=16, positions=50, n_samples=16000, mhfa_heads=8,
            mhfa_compression=16, mhfa_outputs=32)
CELL = "whisper-mhfa.offline"


def tiny_cell():
    cell = tiny(CELL)
    cell.config.update(TINY)
    return cell


def test_ops_by_hand():
    t, d, f = 1500, 1280, 5120
    assert yardstick.frames(CFG) == 3000 and yardstick.positions(CFG) == t
    mel = 3001 * (2.5 * 400 * 8.643856189774725 + 400 + 3 * 201 + 2 * counts.mel_nnz(CFG))
    assert yardstick.logmel_ops(CFG) == pytest.approx(mel, rel=1e-12)
    stem = 2 * 128 * 3 * d * 3000 + 2 * d * 3 * d * t
    assert yardstick.stem_ops(CFG) == stem == 17_694_720_000
    layer = t * (8 * d * d + 4 * d * f) + 4 * t * t * d  # q k v out, the FFN, then Q K^T and A V
    assert sum(yardstick.layer_ops(CFG).values()) == layer
    mhfa = 4 * 33 * d * t + 4 * d * 128 * t + 2 * 2 * 128 * 64 * t + 2 * 8192 * 256 + 2 * 256 * 2
    assert yardstick.mhfa_ops(CFG) == mhfa
    total = mel + stem + 32 * layer + mhfa
    assert yardstick.score_ops(CFG) == pytest.approx(total, rel=1e-12)
    assert total / 1e9 == pytest.approx(2275.09, abs=0.005)
    # the SGEMMs of the layers 83.0%, Q K^T and A V 16.2%, the stem 0.78%, the log-mel 0.0014%
    assert 32 * t * (8 * d * d + 4 * d * f) / total == pytest.approx(0.8296, abs=5e-4)
    assert 32 * 4 * t * t * d / total == pytest.approx(0.1620, abs=5e-4)
    assert stem / total == pytest.approx(0.00778, abs=5e-5)
    assert 150 < counts.mel_nnz(CFG) < 600  # 128 triangles over 201 bins, the low ones a bin or two wide


def test_attention_bound_by_hand():
    b = yardstick.attention_bound(CFG, 16)
    assert b["ops"] == 4 * 16 * 1500 ** 2 * 1280 == 184_320_000_000
    assert b["bytes"] == 4 * 4 * 16 * 1500 * 1280
    # 184.32 GFLOP at 494.7 TFLOP/s against 0.49 GB at 3.35 TB/s
    assert b["by"] == "operations" and b["bound_s"] * 1e3 == pytest.approx(0.37259, abs=5e-5)


def test_k1_bound_by_hand():
    b = counts.mel_bound(CFG, 16)
    assert b["bytes"] == 16 * (480000 * 4 + 3001 * 128 * 4)
    # 55.3 MB at 3.35 TB/s against 0.50 GFLOP at 67 TFLOP/s
    assert b["by"] == "bytes" and b["bound_s"] * 1e6 == pytest.approx(16.509, abs=5e-3)


def test_readers_on_a_synthetic_trace():
    names = {m["name"] for m in load_cell(CELL).per_layer}
    assert {"whisper.attention_roofline", "k1_roofline", "whisper.stem_ms.score",
            "whisper.logmel_ms.score", "span.attention_ms.score", "span.frontend_ms.score",
            "span.model_ms.score", "mfu.score", "idle.score"} <= names
    assert not names & {"xlsr.attention_roofline", "w2vbert.attention_roofline", "k3_roofline",
                        "frontend_ms.score", "model_ms.score"}
    kernels = {"fmha_cutlassF_f32_aligned_64x64_rf_sm80(AttentionKernel<float, ...>)": [5e-3, 3e-3],
               "void (anonymous namespace)::mel_core<float, 128>(float const*, ...)": [2e-4],
               "sm80_xmma_gemm_f32f32": [5e-3]}
    t = TraceSummary(window_s=1.0, busy_s=0.9, kernels=kernels)
    ctx = {"trace": t, "utterances_per_call": 16, "config": CFG}
    attention, k1 = metric_reader("whisper.attention_roofline").read, metric_reader("k1_roofline").read
    assert attention(ctx) == pytest.approx(100 * yardstick.attention_bound(CFG, 16)["bound_s"] / 4e-3)
    assert k1(ctx) == pytest.approx(100 * counts.mel_bound(CFG, 16)["bound_s"] / 2e-4)
    bare = {**ctx, "trace": TraceSummary(1.0, 0.9, {"sm80_xmma_gemm_f32f32": [5e-3]})}
    for read in (attention, k1):
        assert read(bare) is None and read({**ctx, "trace": None}) is None


SPAN_READERS = {"whisper.stem_ms.score": "whisper.conv_stem", "whisper.logmel_ms.score": "whisper.log_mel"}


@pytest.mark.parametrize("name", sorted(SPAN_READERS))
def test_span_readers_give_ms_per_call_of_their_span(monkeypatch, name):
    readings = {"score.call": (5000.0, 100), "whisper.conv_stem": (770.0, 100), "whisper.log_mel": (65.0, 100)}
    monkeypatch.setattr(profiling, "span_readings", lambda: readings)
    ctx = {"trace": TraceSummary(window_s=10.0, busy_s=9.9, kernels={"k": [0.1]}), "rate_utt_per_s": 160.0,
           "utterances_per_call": 16}
    reader = metric_reader(name)
    assert reader.read(ctx) == pytest.approx(readings[SPAN_READERS[name]][0] / 100)
    assert reader.read({**ctx, "trace": None}) is None
    monkeypatch.setattr(profiling, "span_readings", lambda: {"score.call": (5000.0, 100)})
    assert reader.read(ctx) is None  # a program without the span, as the parent is: left out


@pytest.mark.parametrize("name", sorted(SPAN_READERS))
def test_span_entries_read_the_cell_alone(name):
    entry = {m["name"]: m for m in read_json(ROOT / "BENCHMARK.json")["per_layer"]}[name]
    assert entry["source"] == "program_span" and entry["unit"] == "ms" and entry["moves"] == "score_utt_per_s"
    assert entry["workloads"] == [CELL]


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


def _normalised(power: torch.Tensor, utt_axes: int = 2) -> torch.Tensor:
    """``whisper_log_mel``'s normalisation of a mel power, its max taken
    over the trailing ``utt_axes`` axes."""
    return (power_to_db(power, ref=1.0, amin=1e-10, top_db=80.0, utt_axes=utt_axes) / 10.0 + 4.0) / 4.0


def _batch_max(y, cfg):
    """The log-mel clipped at the batch's max - 8 (openai's package)."""
    power = mel_mod.melspectrogram(y, cfg)[..., :-1]
    return _normalised(power, utt_axes=power.dim())


def _first_dropped(y, cfg):
    """Frames 1 .. 3,000: the 3,001st kept and the first dropped, so the
    shapes still fit."""
    return _normalised(mel_mod.melspectrogram(y, cfg)[..., 1:])


def _plant(name: str, monkeypatch, system) -> None:
    """One fault in the port, or in what the system builds of it."""
    if name == "positions_omitted":
        monkeypatch.setattr(whisper.WhisperEncoder, "embed_positions", lambda self, x: x)
    elif name == "k_bias":
        monkeypatch.setattr(whisper.WhisperLayer, "k_bias", True)
        make = system.make_weights

        def with_k_bias(cfg, generator, device, spec):
            w = make(cfg, generator, device, spec)
            g = torch.Generator(device=device).manual_seed(17)
            for n in range(cfg["layers"]):
                w[f"whisper.layers.{n}.k.bias"] = torch.randn(cfg["hidden"], generator=g, device=device)
            return w
        monkeypatch.setattr(system, "make_weights", with_k_bias)
    elif name == "batch_max":
        monkeypatch.setattr(whisper, "whisper_log_mel", _batch_max)
    elif name == "first_frame_dropped":
        monkeypatch.setattr(whisper, "whisper_log_mel", _first_dropped)
    elif name == "tanh_gelu":
        gelu = torch.nn.functional.gelu
        monkeypatch.setattr(torch.nn.functional, "gelu", lambda x, approximate="none": gelu(x, approximate="tanh"))
    elif name == "before_final_norm":
        states = whisper.WhisperEncoder.hidden_states

        def before_norm(self, mel):
            norm, self.norm = self.norm, torch.nn.Identity()
            try:
                return states(self, mel)
            finally:
                self.norm = norm
        monkeypatch.setattr(whisper.WhisperEncoder, "hidden_states", before_norm)
    else:
        build = system.build

        def broken(*a, **k):
            program = build(*a, **k)
            program.score = _half_altered(program.score)
            return program
        monkeypatch.setattr(system, "build", broken)


# The cell's traffic (noise shares 0.05-1) puts no mel bin 8 decades below
# its clip's peak, so neither the clip's own max nor the batch's clips
# anything there, and a batch-wide max reads exactly as the port does. Tones
# with almost no noise (Hann leakage falls past 8 decades far from a tone)
# let the clip act; on them the batch-wide max is caught.
QUIET = {"noise_share": [0.0, 0.001]}
# Under N(0, 0.02) weights fc1's outputs have an rms of 0.02 sqrt(hidden),
# and tanh's departure from the exact GELU grows as x^4 near 0: at hidden
# 64 it reads 3.7e-4 against the clean 1.9e-4, inside any limit; at the
# published width (two layers) 0.0174 against 1.5e-4
WIDE = {"hidden": 1280, "ffn": 5120, "heads": 20}


@pytest.mark.parametrize("fault, audio, size", [("positions_omitted", {}, {}), ("batch_max", QUIET, {}),
                                                ("first_frame_dropped", {}, {}), ("tanh_gelu", {}, WIDE),
                                                ("before_final_norm", {}, {}), ("half_altered", {}, {})])
def test_fault_is_not_correct(fault, audio, size, monkeypatch):
    torch.set_num_threads(4)
    cell = tiny_cell()
    cell.traffic["audio"].update(audio)
    cell.config.update(size)
    _plant(fault, monkeypatch, cell.system())
    result = run(cell)
    assert not result["correct"] and result["failed"] > 0


def test_batch_max_is_invisible_on_the_cells_traffic(monkeypatch):
    torch.set_num_threads(4)
    clean = run(tiny_cell())["checks"]["score_gap"]["value"]
    cell = tiny_cell()
    _plant("batch_max", monkeypatch, cell.system())
    assert run(cell)["checks"]["score_gap"]["value"] == clean


def test_k_bias_is_correct_as_the_softmax_cancels_it(monkeypatch):
    torch.set_num_threads(4)
    cell = tiny_cell()
    _plant("k_bias", monkeypatch, cell.system())
    result = run(cell)
    assert result["correct"], result["checks"]


def test_benchmark_texts_fit_their_limits():
    """Every ``why``, ``layer`` and configuration ``source`` in
    ``BENCHMARK.json``, this cell's entries among them, is 1 to 200
    characters on one line with no tab."""
    bench = read_json(ROOT / "BENCHMARK.json")
    texts = [(c["name"], c[k]) for c in bench["configs"] for k in ("why", "source")]
    texts += [(w["name"], w["why"]) for w in bench["workloads"]]
    texts += [(m["name"], m["layer"]) for m in bench["per_layer"]]
    assert "whisper-mhfa" in {name for name, _ in texts}
    for name, text in texts:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text, (name, len(text))
