"""The ``voxtral-detect`` cell on the CPU: the yardstick's counts against
hand arithmetic and against the program's own per-call counts, the decoder
attention's bound, the cell's readers on synthetic span readings, the cell
as ``harness/cells.py`` loads it, and ``correct`` at a tiny size: the port
agrees with the reference, and each planted fault is not correct: RoPE
left out, attention not causal, KV heads tiled (``h % 8``) in place of
grouped (``h // 4``), the projector's 4 frames taken across windows, the
audio spliced one position early, a clip's windows reversed, a log-mel of
each window alone in place of the whole clip's, half a batch altered."""

from __future__ import annotations

import time

import pytest
import torch

from audioanalysisdetector_tpu_torch.frontend.mel import whisper_log_mel
from audioanalysisdetector_tpu_torch.models import voxtral
from audioanalysisdetector_tpu_torch.utils import profiling
from portbench.harness.cells import BENCH_DIR, ROOT, load_cell, metric_reader, read_json
from portbench.harness.report import report
from portbench.harness.trace import TraceSummary
from portbench.tests.conftest import tiny
from portbench.yardstick import counts
from portbench.yardstick import voxtral_detect as yardstick
from portbench.yardstick import whisper_mhfa

CFG = read_json(BENCH_DIR / "configs" / "voxtral-detect.json")
TINY = dict(hidden=64, heads=4, ffn=256, layers=2, n_mels=128, positions=40, window_frames=80, n_samples=25600,
            lm_hidden=64, lm_heads=8, lm_kv_heads=2, lm_head_dim=16, lm_ffn=96, lm_layers=2, vocab=2000,
            calibration_rows=4)
CELL = "voxtral-detect.offline"
NEW = ("voxtral.decoder_ms.score", "voxtral.lm_attention_roofline")


def tiny_cell():
    cell = tiny(CELL)
    cell.config.update(TINY)
    return cell


def test_ops_by_hand():
    assert (yardstick.windows(CFG), yardstick.audio_tokens(CFG), yardstick.positions(CFG)) == (10, 3750, 3770)
    mel = 30001 * counts.mel_frame_ops(CFG)  # the whole clip's frames, the last one too
    assert yardstick.logmel_ops(CFG) == pytest.approx(mel, rel=1e-12)
    window = 2275.09e9 - whisper_mhfa.mhfa_ops(read_json(BENCH_DIR / "configs" / "whisper-mhfa.json")) \
        - whisper_mhfa.logmel_ops(read_json(BENCH_DIR / "configs" / "whisper-mhfa.json"))
    assert yardstick.encoder_ops(CFG) == pytest.approx(10 * window, rel=1e-5)  # whisper-mhfa's window, ten times
    t, d, f = 3770, 3072, 8192
    proj = 2 * t * d * (2 * 4096 + 2 * 1024)
    attention = 4 * 4096 * t * (t + 1) / 2  # Q K^T and A V over the causal pairs
    assert yardstick.decoder_layer_ops(CFG) == {"attn_proj": proj, "ffn": 6 * t * d * f, "attention": attention}
    assert yardstick.projector_ops(CFG) == 3750 * 2 * (5120 * 3072 + 3072 * 3072)
    assert yardstick.head_ops(CFG) == 2 * 131072 * 3072
    total = yardstick.score_ops(CFG)
    assert total / 1e12 == pytest.approx(50.615, abs=5e-4)
    # a clip: the encoder 44.9%, the decoder's projections and SwiGLU 47.8%, its attention 6.9%
    assert yardstick.encoder_ops(CFG) / total == pytest.approx(0.4492, abs=5e-4)
    assert 30 * (proj + 6 * t * d * f) / total == pytest.approx(0.4780, abs=5e-4)
    assert 30 * attention / total == pytest.approx(0.0690, abs=5e-4)
    # the decoder's weights at every position: 2 x 3.209 G x 3,770
    assert 30 * (proj + 6 * t * d * f) == pytest.approx(2 * 3_208_826_880 * t, rel=1e-4)


def test_lm_attention_bound_by_hand():
    b = yardstick.lm_attention_bound(CFG, 2)
    pairs = 3770 * 3771 / 2
    assert b["ops"] == 30 * 2 * 4 * 4096 * pairs
    assert b["bytes"] == 30 * 4 * 2 * 3770 * (2 * 4096 + 2 * 1024)
    # 6.99 TFLOP at 494.7 TFLOP/s against 9.27 GB at 3.35 TB/s
    assert b["by"] == "operations" and b["bound_s"] * 1e3 == pytest.approx(14.125, abs=5e-3)


def test_program_counts_what_the_yardstick_counts():
    """One call of the tiny program: the windows it encoded and the
    positions it decoded are the yardstick's, clip by clip."""
    cell = tiny_cell()
    cfg = cell.config
    system = cell.system()
    g = torch.Generator().manual_seed(5)
    weights = system.make_weights(cfg, g, "cpu", cell.traffic["audio"])
    program = system.build(cfg, weights, {}, "cpu")
    wav = torch.randn(3, cfg["n_samples"], generator=g) * 0.1
    voxtral.reset_work_counts()
    program.score(wav)
    assert voxtral.work_counts() == {"voxtral.calls": 1, "voxtral.windows": 3 * yardstick.windows(cfg),
                                     "voxtral.positions": 3 * yardstick.positions(cfg)}
    assert (yardstick.windows(cfg), yardstick.positions(cfg)) == (2, 4 + 20 + 16)
    voxtral.reset_work_counts()


def test_cell_loads_with_its_metrics():
    cell = load_cell(CELL)
    names = {m["name"] for m in cell.per_layer}
    assert names == {"mfu.score", "idle.score", "span.frontend_ms.score", "span.model_ms.score",
                     "span.attention_ms.score", "k1_roofline", *NEW}
    assert [m["name"] for m in cell.end_to_end] == ["setup_s", "score_utt_per_s"]
    assert cell.chips == 1 and cell.traffic["batch"] == 2 and cell.config["n_samples"] == 4_800_000
    assert cell.system().score_ops is yardstick.score_ops
    bench = read_json(ROOT / "BENCHMARK.json")
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in NEW:  # not ``span.*``: that prefix is held to another test's readers
        assert entries[name]["workloads"] == [CELL] and entries[name]["source"] == "program_span"
        assert entries[name]["moves"] == "score_utt_per_s" and not name.startswith("span.")


def test_k1_roofline_reads_one_launch_over_the_whole_clips():
    # 2 rows of 4,800,000 samples, 30,001 frames each: one launch a call
    b = counts.mel_bound(CFG, 2)
    assert b["bytes"] == 2 * (4_800_000 * 4 + 30_001 * 128 * 4)
    kernels = {"void (anonymous namespace)::mel_core<float, 128>(float const*, ...)": [4e-4, 6e-4],
               "fmha_cutlassF_f32_aligned_64x128_rf_sm80(AttentionKernel<float, ...>)": [5e-3]}
    ctx = {"trace": TraceSummary(window_s=10.0, busy_s=9.9, kernels=kernels), "utterances_per_call": 2,
           "config": CFG}
    assert metric_reader("k1_roofline").read(ctx) == pytest.approx(100 * b["bound_s"] / 5e-4)


def test_prompt_ids_are_the_benchmarks_own():
    system = load_cell(CELL).system()
    cfg = {**CFG, "vocab": 1030, "audio_token_id": 1010}  # 29 ids to draw 22 from, one excluded
    for seed in range(8):
        ids = system.prompt_ids(cfg, torch.Generator().manual_seed(seed), "cpu")
        assert [tuple(ids[k].shape) for k in ("prefix_ids", "suffix_ids", "answer_ids")] == [(4,), (16,), (2,)]
        drawn = torch.cat(list(ids.values()))
        assert drawn.unique().numel() == 22 and int(drawn.min()) >= 1000 and int(drawn.max()) < 1030
        assert not (drawn == 1010).any()


READINGS = {"score.call": (2400.0, 4), "voxtral.decoder": (5000.0, 4), "lm.attend": (880.0, 4)}


def _ctx(**kw):
    return {"trace": TraceSummary(window_s=9.6, busy_s=9.5, kernels={"k": [0.1]}), "rate_utt_per_s": 2 * 4 / 9.6,
            "utterances_per_call": 2, "config": CFG, **kw}


def test_readers_on_synthetic_readings(monkeypatch):
    monkeypatch.setattr(profiling, "span_readings", lambda: READINGS)
    decoder, roofline = (metric_reader(n).read for n in NEW)
    assert decoder(_ctx()) == pytest.approx(1250.0)
    bound = yardstick.lm_attention_bound(CFG, 2)["bound_s"]
    assert roofline(_ctx()) == pytest.approx(100 * bound / 0.220)
    for read in (decoder, roofline):
        assert read(_ctx(trace=None)) is None
    monkeypatch.setattr(profiling, "span_readings", lambda: {"score.call": (2400.0, 4)})
    assert decoder(_ctx()) is None and roofline(_ctx()) is None  # a program without the spans, as the parent


def run(cell, seed: int = 2**31 + 3, seconds: float = 0.3):
    return report(cell, seed=seed, seconds=seconds, trace=False, device="cpu", t_start=time.perf_counter())[0]


def test_port_agrees_with_reference():
    torch.set_num_threads(4)
    result = run(tiny_cell())
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == {"setup_s", "score_utt_per_s"}


def _tiled(q, k, v):
    """``lm_attend`` with the KV heads tiled: query head h reads KV head h % 8."""
    b, h, t, d = q.shape
    group = h // k.shape[1]
    a = torch.nn.functional.scaled_dot_product_attention(q, k.repeat(1, group, 1, 1), v.repeat(1, group, 1, 1),
                                                         is_causal=True)
    return a.transpose(1, 2).reshape(b, t, h * d)


def _not_causal(q, k, v):
    b, h, t, d = q.shape
    group = h // k.shape[1]
    a = torch.nn.functional.scaled_dot_product_attention(q, k.repeat_interleave(group, 1),
                                                         v.repeat_interleave(group, 1))
    return a.transpose(1, 2).reshape(b, t, h * d)


def _across_windows(positions: int):
    """The projector's groups of 4 taken across the windows: frame t of 4
    windows in a row, not 4 consecutive frames of one window."""
    def forward(self, states):
        b, n, d = states.shape
        across = states.view(b, n // positions, positions, d).transpose(1, 2).reshape(b, -1, self.linear_1.in_features)
        return self.linear_2(torch.nn.functional.gelu(self.linear_1(across)))
    return forward


def _early_splice(self, audio_tokens):
    """The audio placeholders one position early: the last prefix id after them."""
    audio = torch.full((audio_tokens,), self.cfg.audio_token_id, dtype=torch.long, device=self.prefix_ids.device)
    return torch.cat([self.prefix_ids[:-1], audio, self.prefix_ids[-1:], self.suffix_ids])


def _per_window_log_mel(self, wav):
    """Each window's log-mel alone: its own max, and reflect padding at every window's edges."""
    b = wav.shape[0]
    mel = whisper_log_mel(wav.reshape(-1, self.window_samples), self.cfg.audio.mel)
    return mel.view(b, -1, *mel.shape[1:])


def _half_altered(score):
    def altered(wav):
        out = score(wav).clone()
        out[out.shape[0] // 2:] += 0.01
        return out
    return altered


def _plant(name: str, monkeypatch, system, cfg: dict) -> None:
    """One fault in the port, or in what the system builds of it."""
    model = voxtral.VoxtralDetector
    if name == "no_rope":
        monkeypatch.setattr(voxtral, "apply_rope", lambda x, cos, sin: x)
    elif name == "not_causal":
        monkeypatch.setattr(voxtral, "lm_attend", _not_causal)
    elif name == "kv_tiled":
        monkeypatch.setattr(voxtral, "lm_attend", _tiled)
    elif name == "projector_across_windows":
        monkeypatch.setattr(voxtral.Projector, "forward", _across_windows(cfg["positions"]))
    elif name == "early_splice":
        monkeypatch.setattr(model, "prompt_ids", _early_splice)
    elif name == "windows_reversed":
        encode = model.encode
        monkeypatch.setattr(model, "encode", lambda self, mel: encode(self, mel.flip(1)))
    elif name == "per_window_log_mel":
        monkeypatch.setattr(model, "features", _per_window_log_mel)
    else:
        build = system.build

        def broken(*a, **k):
            program = build(*a, **k)
            program.score = _half_altered(program.score)
            return program
        monkeypatch.setattr(system, "build", broken)


FAULTS = ["no_rope", "not_causal", "kv_tiled", "projector_across_windows", "early_splice", "windows_reversed",
          "per_window_log_mel", "half_altered"]


@pytest.mark.parametrize("fault", FAULTS)
def test_fault_is_not_correct(fault, monkeypatch):
    torch.set_num_threads(4)
    cell = tiny_cell()
    _plant(fault, monkeypatch, cell.system(), cell.config)
    result = run(cell)
    assert not result["correct"] and result["failed"] > 0, result["checks"]


def test_benchmark_texts_fit_their_limits():
    """This cell's ``why``, ``layer`` and configuration ``source`` in
    ``BENCHMARK.json``: 1 to 200 characters on one line with no tab."""
    bench = read_json(ROOT / "BENCHMARK.json")
    texts = [(c["name"], c[k]) for c in bench["configs"] if c["name"] == "voxtral-detect" for k in ("why", "source")]
    texts += [(w["name"], w["why"]) for w in bench["workloads"] if w["name"] == CELL]
    texts += [(m["name"], m["layer"]) for m in bench["per_layer"] if m["name"] in NEW]
    assert len(texts) == 5
    for name, text in texts:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text, (name, len(text))
