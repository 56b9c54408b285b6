"""WavLM-Large + MHFA in the port (``models/wav2vec2.py::WavLM``,
``models/mhfa.py``, ``score/e2e.py``, ``convert.wavlm_to_port``, ``score
--model wavlm-mhfa``), on the CPU.

The port is held to the benchmark's plain reference
(``portbench/reference/wavlm_mhfa.py``, plain torch, importing nothing of
the port) at a tiny size (conv channels 32, hidden 64, 4 heads, FFN 128, 2
layers, positional kernel 16 in 4 groups, 32 buckets up to distance 40 so
that 1-s inputs reach the logarithmic and the clipped buckets; MHFA 8
heads, compression 16, 32 outputs) on the benchmark's seeded, calibrated
weights. The JAX package has no such model, so the reference is the only
yardstick here.
"""

import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from audioanalysisdetector_tpu_torch.cli.main import main as cli_main
from audioanalysisdetector_tpu_torch.convert import wavlm_to_port
from audioanalysisdetector_tpu_torch.io.audio import load_audio, write_wav
from audioanalysisdetector_tpu_torch.models import wav2vec2
from audioanalysisdetector_tpu_torch.models.aasist import SSLAASIST
from audioanalysisdetector_tpu_torch.models.mhfa import WavLMMHFA
from audioanalysisdetector_tpu_torch.models.wav2vec2 import WAVLM_LARGE, WavLM, WavLMConfig, XLSRConfig, relative_buckets
from audioanalysisdetector_tpu_torch.score import e2e
from audioanalysisdetector_tpu_torch.score.streaming import tile_pad

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from portbench.harness.audio import seed_generator, waves  # noqa: E402
from portbench.harness.cells import BENCH_DIR, read_json  # noqa: E402
from portbench.reference import wavlm_mhfa as ref  # noqa: E402
from portbench.systems import wavlm_mhfa as system  # noqa: E402

torch.set_num_threads(2)

TINY = dict(conv_dim=32, hidden=64, heads=4, ffn=128, layers=2, pos_kernel=16, pos_groups=4, n_samples=16000,
            rel_buckets=32, rel_max_distance=40, mhfa_heads=8, mhfa_compression=16, mhfa_outputs=32,
            calibration_rows=8)
CFG = {**read_json(BENCH_DIR / "configs" / "wavlm-mhfa.json"), **TINY}
XCFG = system._wavlm_config(CFG)
AUDIO = read_json(BENCH_DIR / "traffic" / "offline-b32-16s.json")["audio"]
# the port in float32 against the reference in float64: rounding of fp32
# through the conv encoder, two layers and MHFA, measured at <= 5e-6 on the
# logits (std 1.5)
FP32_TOL = 5e-5
# a change of the mathematics moves some logit by far more than rounding
MOVED = 1e-3


def tiny_model() -> WavLMMHFA:
    return WavLMMHFA(XCFG, CFG["mhfa_heads"], CFG["mhfa_compression"], CFG["mhfa_outputs"])


@pytest.fixture(scope="module")
def setup():
    g = seed_generator(2**31 + 5, "cpu")
    weights = system.make_weights(CFG, g, "cpu", AUDIO)
    wav = waves(6, CFG["n_samples"], CFG["sr"], g, "cpu", AUDIO)
    model = tiny_model().eval()
    model.load_state_dict(weights)
    exact = ref.logits(wav.double(), weights, CFG)[:, 1]
    return weights, wav, model, exact


def _logits(model, wav):
    with torch.inference_mode():
        return model(wav)[:, 1].double()


def test_tiny_port_matches_reference_in_float64(setup):
    weights, wav, _, exact = setup
    m64 = tiny_model().double().eval()
    m64.load_state_dict(weights)
    x = wav.double()
    with torch.no_grad():
        states = m64.wavlm.hidden_states(m64.wavlm.features(x))
        ref_states = ref.hidden_states(x, weights, CFG)
        assert len(states) == len(ref_states) == CFG["layers"] + 1
        for got, want in zip(states, ref_states):
            torch.testing.assert_close(got, want, rtol=0, atol=1e-10)
        torch.testing.assert_close(m64.mhfa(states)[:, 1], exact, rtol=0, atol=1e-10)


def test_tiny_port_matches_reference_in_float32(setup):
    _, wav, model, exact = setup
    assert float((_logits(model, wav) - exact).abs().max()) < FP32_TOL
    assert float(exact.std()) > 0.5  # calibrated logits spread: the comparison sees every path


@pytest.mark.parametrize("d,bucket", [(0, 0), (1, 161), (-1, 1), (79, 239), (-79, 79), (80, 240), (-80, 80),
                                      (81, 240), (-81, 80), (799, 319), (-799, 159), (800, 319), (-800, 159),
                                      (1000, 319), (-1000, 159)])
def test_bucket_table_by_hand(d, bucket):
    # 320 buckets, 160 a direction (key after query: the upper half), 80
    # exact, then 80 + floor(log(a / 80) / log(10) * 80), at most 159
    table = relative_buckets(1001, 320, 800, torch.device("cpu"))
    i = 0 if d >= 0 else 1000
    assert int(table[i, i + d]) == bucket


def test_bucket_table_is_the_reference_formula_and_cached():
    cfg = {"rel_buckets": 320, "rel_max_distance": 800}
    table = relative_buckets(1201, 320, 800, torch.device("cpu"))
    assert torch.equal(table, ref.relative_buckets(1201, cfg))
    assert table is relative_buckets(1201, 320, 800, torch.device("cpu"))
    # at T = 799 every distance is below 800, none clipped: every bucket is
    # used but 160 (a key after its query at distance 0, which cannot be)
    used = torch.unique(relative_buckets(799, 320, 800, torch.device("cpu")))
    assert used.tolist() == [b for b in range(320) if b != 160]


def test_gate_is_the_formula():
    g = torch.Generator().manual_seed(1)
    layer = wav2vec2.GatedEncoderLayer(XCFG)
    with torch.no_grad():
        layer.grep_linear.weight.normal_(0.0, 0.2, generator=g)
        layer.grep_linear.bias.normal_(0.0, 0.2, generator=g)
        layer.grep_a.uniform_(0.5, 1.5, generator=g)
    b, t, h, dh = 2, 7, XCFG.heads, XCFG.hidden // XCFG.heads
    x = torch.randn(b, t, XCFG.hidden, generator=g)
    position = torch.randn(h, t, t, generator=g)
    with torch.no_grad():
        got = layer.attention_bias(x, position)
    w, bias = layer.grep_linear.weight, layer.grep_linear.bias
    for bi in range(b):
        for hi in range(h):
            for ti in range(t):
                proj = x[bi, ti, hi * dh:(hi + 1) * dh] @ w.T + bias  # (8,)
                ga, gb = torch.sigmoid(proj[:4].sum()), torch.sigmoid(proj[4:].sum())
                gate = ga * (gb * layer.grep_a[0, hi, 0, 0] - 1.0) + 2.0
                torch.testing.assert_close(got[bi, hi, ti], gate * position[hi, ti], rtol=1e-6, atol=1e-6)


def _moved(model, wav, exact) -> float:
    return float((_logits(model, wav) - exact).abs().max())


def test_gate_position_and_normalisation_each_move_the_answer(setup, monkeypatch):
    weights, wav, model, exact = setup
    assert _moved(model, wav, exact) < FP32_TOL
    with monkeypatch.context() as m:  # G replaced by 1
        m.setattr(wav2vec2.GatedEncoderLayer, "attention_bias", lambda self, x, bias: bias)
        assert _moved(model, wav, exact) > MOVED
    with monkeypatch.context() as m:  # P transposed: query minus key
        position = WavLM.position_bias
        m.setattr(WavLM, "position_bias", lambda self, t, device: position(self, t, device).transpose(1, 2))
        assert _moved(model, wav, exact) > MOVED
    plain = WavLMMHFA(dataclasses.replace(XCFG, normalize=False), CFG["mhfa_heads"], CFG["mhfa_compression"],
                      CFG["mhfa_outputs"]).eval()
    plain.load_state_dict(weights)
    assert _moved(plain, wav, exact) > MOVED


def test_xlsr_layer_makes_the_unmasked_sdpa_call(monkeypatch):
    calls = []
    sdpa = F.scaled_dot_product_attention

    def spy(*args, **kwargs):
        calls.append(kwargs)
        return sdpa(*args, **kwargs)

    monkeypatch.setattr(F, "scaled_dot_product_attention", spy)
    layer = wav2vec2.EncoderLayer(XLSRConfig(hidden=64, heads=4, ffn=128)).eval()
    with torch.no_grad():
        layer(torch.randn(2, 5, 64))
    assert calls == [{"attn_mask": None}]


def test_hidden_states_are_each_layers_input_then_the_final_norm(setup):
    _, wav, model, _ = setup
    with torch.inference_mode():
        feats = model.wavlm.features(wav)
        states = model.wavlm.hidden_states(feats)
        assert len(states) == 3
        h = model.wavlm.embed_positions(feats)
        position = model.wavlm.position_bias(h.shape[1], h.device)
        for layer, state in zip(model.wavlm.layers, states):
            torch.testing.assert_close(state, h, rtol=0, atol=0)
            h = layer(h, position)
        torch.testing.assert_close(states[-1], model.wavlm.norm(h), rtol=0, atol=0)
        torch.testing.assert_close(model.wavlm(wav), states[-1], rtol=0, atol=0)


def test_published_widths_on_meta():
    assert WAVLM_LARGE == WavLMConfig(conv_bias=False, normalize=True, rel_buckets=320, rel_max_distance=800)
    assert not hasattr(XLSRConfig(), "rel_buckets")  # XLS-R carries no WavLM field
    with torch.device("meta"):
        model = WavLMMHFA()
        xlsr = SSLAASIST().xlsr
    assert sum(p.numel() for p in model.wavlm.parameters()) == 315_451_968
    assert sum(p.numel() for p in xlsr.parameters()) == 315_437_568
    wav = torch.empty(2, e2e.WAVLM_MHFA_SAMPLES, device="meta")
    assert e2e.WAVLM_MHFA_SAMPLES == 256000 and model.wavlm.features(wav).shape == (2, 799, 1024)
    bench = read_json(BENCH_DIR / "configs" / "wavlm-mhfa.json")
    assert system._wavlm_config(bench) == WAVLM_LARGE
    # every tensor the benchmark states, by name and shape, and no other
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == system.shapes(bench)


def test_scorer_is_the_bona_fide_logit_under_spans(setup):
    _, wav, model, _ = setup
    score = e2e.make_wavlm_mhfa_scorer(model)
    assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = score(wav)
    with torch.inference_mode():
        torch.testing.assert_close(out, model(wav)[:, 1])
    spans = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
             for e in prof.profiler.kineto_results.events() if e.is_user_annotation()]
    named = {n: [s for s in spans if s[0] == n] for n in {s[0] for s in spans}}
    counts = {"score.call": 1, "score.frontend": 1, "score.model": 1, "wavlm.features": 1, "wavlm.encoder": 1,
              "wavlm.position_bias": 1, "wavlm.gated_bias": CFG["layers"], "ssl.attend": CFG["layers"],
              "mhfa.pool": 1}
    assert {n: len(v) for n, v in named.items()} == counts
    nest = {"score.frontend": "score.call", "score.model": "score.call", "wavlm.features": "score.frontend",
            "wavlm.encoder": "score.frontend", "wavlm.position_bias": "wavlm.encoder",
            "wavlm.gated_bias": "wavlm.encoder", "ssl.attend": "wavlm.encoder", "mhfa.pool": "score.model"}
    for inner, outer in nest.items():
        (o,) = named[outer]
        assert all(o[1] <= s[1] and s[2] <= o[2] for s in named[inner]), inner


def test_score_cli_wavlm_mhfa_tiles_and_cuts(tmp_path, monkeypatch, capsys):
    d = tmp_path / "audio"
    d.mkdir()
    rng = np.random.default_rng(1)
    clips = {"long.wav": rng.standard_normal(21000) * 0.1, "short.wav": rng.standard_normal(7000) * 0.1}
    for name, y in clips.items():
        write_wav(str(d / name), np.clip(y, -0.99, 0.99), 16000)
    model = tiny_model().eval()
    e2e._init_uniform(model, torch.Generator().manual_seed(2))
    monkeypatch.setattr(e2e, "WAVLM_MHFA_SAMPLES", 16000)
    monkeypatch.setattr(e2e, "init_wavlm_mhfa", lambda checkpoint, device: model)
    assert cli_main(["score", str(d), "--model", "wavlm-mhfa", "--allow-random", "--device", "cpu"]) == 0
    lines = [json.loads(s) for s in capsys.readouterr().out.strip().splitlines()]
    assert [Path(x["file"]).name for x in lines] == sorted(clips)
    assert all(set(x) == {"file", "bonafide_logit"} for x in lines)
    rows = []
    for name in sorted(clips):
        y = load_audio(str(d / name), sr=16000)[0]
        row = np.zeros(16000, np.float32)
        row[:min(len(y), 16000)] = y[:16000]
        rows.append(tile_pad(row, len(y)))
    with torch.inference_mode():
        want = model(torch.from_numpy(np.stack(rows)))[:, 1].numpy()
    np.testing.assert_allclose([x["bonafide_logit"] for x in lines], want, rtol=0, atol=1e-5)
    assert cli_main(["score", str(d), "--model", "wavlm-mhfa", "--allow-random", "--device", "cpu",
                     "--sr", "8000"]) == 2


def _published_state(model: WavLM, g: torch.Generator, *, parametrized: bool) -> tuple[dict, torch.nn.Conv1d]:
    """A synthetic transformers ``WavLMModel`` state dict in the published
    names for the tiny shape, the positional conv weight-normed by torch's
    own parametrization (saved in the older ``weight_g`` / ``weight_v``
    names, or the newer ``parametrizations`` ones), with the pre-training
    mask embedding present; and that conv."""
    sd = {k: torch.randn(v.shape, generator=g) for k, v in model.state_dict().items()}
    pub = {}
    for i in range(len(XCFG.conv_kernels)):
        pub[f"feature_extractor.conv_layers.{i}.conv.weight"] = sd[f"conv.convs.{i}.weight"]
        for p in ("weight", "bias"):
            pub[f"feature_extractor.conv_layers.{i}.layer_norm.{p}"] = sd[f"conv.norms.{i}.{p}"]
    for p in ("weight", "bias"):
        pub[f"feature_projection.layer_norm.{p}"] = sd[f"feature_norm.{p}"]
        pub[f"feature_projection.projection.{p}"] = sd[f"proj.{p}"]
        pub[f"encoder.layer_norm.{p}"] = sd[f"norm.{p}"]
        for n in range(XCFG.layers):
            for theirs, ours in (("attention.q_proj", "q"), ("attention.k_proj", "k"), ("attention.v_proj", "v"),
                                 ("attention.out_proj", "out"), ("attention.gru_rel_pos_linear", "grep_linear"),
                                 ("layer_norm", "attn_norm"), ("feed_forward.intermediate_dense", "fc1"),
                                 ("feed_forward.output_dense", "fc2"), ("final_layer_norm", "ffn_norm")):
                pub[f"encoder.layers.{n}.{theirs}.{p}"] = sd[f"layers.{n}.{ours}.{p}"]
    for n in range(XCFG.layers):
        pub[f"encoder.layers.{n}.attention.gru_rel_pos_const"] = sd[f"layers.{n}.grep_a"]
    pub["encoder.layers.0.attention.rel_attn_embed.weight"] = sd["rel_attn_embed.weight"]
    conv = torch.nn.Conv1d(XCFG.hidden, XCFG.hidden, XCFG.pos_kernel, padding=XCFG.pos_kernel // 2,
                           groups=XCFG.pos_groups)
    conv = torch.nn.utils.parametrizations.weight_norm(conv, name="weight", dim=2)
    with torch.no_grad():
        conv.parametrizations.weight.original0.uniform_(0.5, 1.5, generator=g)
        conv.parametrizations.weight.original1.normal_(generator=g)
    names = (("parametrizations.weight.original0", "parametrizations.weight.original1") if parametrized
             else ("weight_g", "weight_v"))
    pub[f"encoder.pos_conv_embed.conv.{names[0]}"] = conv.parametrizations.weight.original0.detach().clone()
    pub[f"encoder.pos_conv_embed.conv.{names[1]}"] = conv.parametrizations.weight.original1.detach().clone()
    pub["encoder.pos_conv_embed.conv.bias"] = conv.bias.detach().clone()
    pub["masked_spec_embed"] = torch.randn(XCFG.hidden, generator=g)
    return pub, conv


@pytest.mark.parametrize("parametrized", [False, True], ids=["weight_g", "parametrizations"])
def test_convert_published_names_and_weight_norm_fold(parametrized):
    g = torch.Generator().manual_seed(3)
    model = WavLM(XCFG).eval()
    published, conv = _published_state(model, g, parametrized=parametrized)
    state = wavlm_to_port(published)
    model.load_state_dict(state)  # strict: every tensor placed, none left over
    torch.testing.assert_close(model.pos_conv.weight, conv.weight, rtol=1e-6, atol=1e-7)
    # under a head model's ``wavlm.`` prefix, the head's own tensors not taken
    headed = {**{f"wavlm.{k}": v for k, v in published.items()}, "classifier.weight": torch.zeros(2, 4)}
    for k, v in wavlm_to_port(headed).items():
        torch.testing.assert_close(v, state[k], rtol=0, atol=0)
    bad = {**published, "encoder.layers.0.attention.extra.weight": torch.zeros(1)}
    with pytest.raises(KeyError):
        wavlm_to_port(bad)



@pytest.mark.parametrize("form", ["folded", "fairseq"])
def test_convert_without_weight_norm_names_what_it_expects(form):
    published, conv = _published_state(WavLM(XCFG), torch.Generator().manual_seed(5), parametrized=False)
    pos = "encoder.pos_conv_embed.conv."
    state = {k: v for k, v in published.items() if not k.startswith(pos + "weight_")}
    state[pos + "weight"] = conv.weight.detach().clone()
    if form == "fairseq":  # WavLM-Large.pt: the config beside the model's tensors
        state = {"cfg": {"normalize": True}, "model": state}
    with pytest.raises(KeyError, match="weight_g / weight_v.*WavLM-Large.pt format is not supported"):
        wavlm_to_port(state)

def test_init_takes_a_published_front_end_and_keeps_the_seeded_back_end(tmp_path, monkeypatch):
    monkeypatch.setattr(e2e, "WavLMMHFA", tiny_model)
    seeded = e2e.init_wavlm_mhfa(seed=7, device="cpu")
    assert all(float(p.abs().max()) == 0 for p in (seeded.mhfa.weights_k, seeded.mhfa.weights_v))
    assert float(seeded.wavlm.layers[0].grep_linear.bias.abs().max()) == 0  # init_bert_params' zero bias
    torch.testing.assert_close(seeded.wavlm.layers[1].grep_a, torch.ones(1, XCFG.heads, 1, 1))
    published, _ = _published_state(WavLM(XCFG), torch.Generator().manual_seed(4), parametrized=False)
    path = tmp_path / "pytorch_model.bin"
    torch.save(published, path)
    model = e2e.init_wavlm_mhfa(checkpoint=str(path), seed=7, device="cpu")
    expected = wavlm_to_port(published)
    for k, v in model.wavlm.state_dict().items():
        torch.testing.assert_close(v, expected[k], rtol=0, atol=0, msg=k)
    for k, v in model.mhfa.state_dict().items():
        torch.testing.assert_close(v, seeded.mhfa.state_dict()[k], rtol=0, atol=0, msg=k)
    torch.save(model.state_dict(), tmp_path / "port.pt")
    again = e2e.init_wavlm_mhfa(checkpoint=str(tmp_path / "port.pt"), seed=8, device="cpu")
    for k, v in again.state_dict().items():
        torch.testing.assert_close(v, model.state_dict()[k], rtol=0, atol=0, msg=k)
