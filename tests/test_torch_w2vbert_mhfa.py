"""w2v-BERT 2.0 + MHFA in the port (``frontend/fbank.py``,
``models/w2v_bert.py``, ``models/mhfa.py``, ``score/e2e.py``,
``convert.w2vbert_to_port``, ``score --model w2vbert-mhfa``), on the CPU.

The port is held to the benchmark's plain reference
(``portbench/reference/w2vbert_mhfa.py``, plain torch, importing nothing of
the port) at a tiny size (hidden 64, 4 heads, FFN 128, 2 layers, the
published kernel 31 and relative window -64 .. 8; MHFA 8 heads,
compression 16, 32 outputs) on the benchmark's seeded, calibrated weights;
its filterbank to transformers' ``SeamlessM4TFeatureExtractor`` and its
encoder to transformers' ``Wav2Vec2BertModel``, the published code, which
the build box has (imported with ``USE_TF=0``; the card machine has no
``transformers``, and neither the port nor the reference imports it). The
JAX package has no such model.
"""

import dataclasses
import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from audioanalysisdetector_tpu_torch.cli.main import main as cli_main
from audioanalysisdetector_tpu_torch.convert import w2vbert_to_port
from audioanalysisdetector_tpu_torch.frontend import fbank as fb
from audioanalysisdetector_tpu_torch.io.audio import load_audio, write_wav
from audioanalysisdetector_tpu_torch.models import w2v_bert
from audioanalysisdetector_tpu_torch.models.mhfa import SSLMHFA, W2VBertMHFA, WavLMMHFA
from audioanalysisdetector_tpu_torch.models.w2v_bert import W2V_BERT_2, ConvModule, W2VBert, relative_key_index
from audioanalysisdetector_tpu_torch.score import e2e
from audioanalysisdetector_tpu_torch.score.streaming import tile_pad

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from portbench.harness.audio import seed_generator, waves  # noqa: E402
from portbench.harness.cells import BENCH_DIR, read_json  # noqa: E402
from portbench.reference import w2vbert_mhfa as ref  # noqa: E402
from portbench.systems import w2vbert_mhfa as system  # noqa: E402

torch.set_num_threads(2)

TINY = dict(hidden=64, heads=4, ffn=128, layers=2, n_samples=16000, mhfa_heads=8, mhfa_compression=16,
            mhfa_outputs=32, calibration_rows=8)
CFG = {**read_json(BENCH_DIR / "configs" / "w2vbert-mhfa.json"), **TINY}
WCFG = system._w2vbert_config(CFG)
AUDIO = read_json(BENCH_DIR / "traffic" / "offline-b32-16s.json")["audio"]
# the port in float32 against the reference in float64: rounding of fp32
# through the projection, two layers and MHFA (the filterbank runs in
# float64), measured at <= 2e-6 on the logits (std 1.5)
FP32_TOL = 2e-5
# transformers' extractor stores the spectrum as complex64 and its
# features as float32 (``audio_utils.spectrogram``, the normalisation in
# numpy float32): its rows differ from a float64 filterbank by <= 5e-5 on
# normalised values of order 1 (measured on the build box)
HF_FBANK_TOL = 2e-4


def tiny_model() -> W2VBertMHFA:
    return W2VBertMHFA(WCFG, CFG["mhfa_heads"], CFG["mhfa_compression"], CFG["mhfa_outputs"])


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
        torch.testing.assert_close(m64.w2vbert.fbank(x), ref.fbank(x, CFG), rtol=0, atol=1e-10)
        states = m64.w2vbert.hidden_states(m64.w2vbert.features(x))
        ref_states = ref.hidden_states(x, weights, CFG)
        assert len(states) == len(ref_states) == CFG["layers"] + 1
        for got, want in zip(states, ref_states):
            torch.testing.assert_close(got, want, rtol=0, atol=1e-10)
        torch.testing.assert_close(m64.mhfa(states)[:, 1], exact, rtol=0, atol=1e-10)


def test_tiny_port_matches_reference_in_float32(setup):
    _, wav, model, exact = setup
    assert float((_logits(model, wav) - exact).abs().max()) < FP32_TOL
    assert float(exact.std()) > 0.5  # calibrated logits spread: the comparison sees every path


@pytest.fixture(scope="module")
def transformers_mod():
    os.environ.setdefault("USE_TF", "0")
    os.environ.setdefault("USE_FLAX", "0")
    return pytest.importorskip("transformers")


def test_fbank_matches_the_published_extractor(transformers_mod):
    extractor = transformers_mod.SeamlessM4TFeatureExtractor()
    g = seed_generator(11, "cpu")
    clips = waves(2, 16000, 16000, g, "cpu", AUDIO)
    ours = fb.kaldi_fbank(clips.double())
    assert ours.shape == (2, 49, 160)  # 98 frames of 400 at hop 160, paired
    for row, clip in zip(ours, clips):
        theirs = extractor(clip.numpy(), sampling_rate=16000, return_tensors="np")["input_features"][0]
        np.testing.assert_allclose(row.numpy(), theirs, rtol=0, atol=HF_FBANK_TOL)
    np.testing.assert_array_equal(fb.kaldi_filterbank(fb.FbankConfig()), extractor.mel_filters.T)
    np.testing.assert_allclose(fb.povey_window(fb.FbankConfig()), extractor.window, rtol=0, atol=1e-15)


def _published_model(transformers_mod, g: torch.Generator):
    """transformers' ``Wav2Vec2BertModel`` at the tiny shape, float64, its
    norms and biases moved off their initial values so each one counts."""
    config = transformers_mod.Wav2Vec2BertConfig(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                                                 intermediate_size=128, conv_depthwise_kernel_size=31)
    model = transformers_mod.Wav2Vec2BertModel(config).double().eval()
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "layer_norm" in name or name.endswith(".bias"):
                p.add_(0.1 * torch.randn(p.shape, generator=g, dtype=p.dtype))
    return model


def test_encoder_matches_the_published_model(transformers_mod):
    g = torch.Generator().manual_seed(3)
    published = _published_model(transformers_mod, g)
    port = W2VBert(dataclasses.replace(W2V_BERT_2, hidden=64, heads=4, ffn=128, layers=2)).double().eval()
    state = published.state_dict()
    assert "masked_spec_embed" in state
    port.load_state_dict(w2vbert_to_port(state))  # strict: every tensor placed, none left over
    # 2-s clips: T = 99 frames, past the relative window's 64 + 8, so the
    # clamped rows of every distance embedding are reached
    feats = fb.kaldi_fbank(waves(2, 32000, 16000, seed_generator(12, "cpu"), "cpu", AUDIO).double())
    with torch.no_grad():
        theirs = published(input_features=feats, output_hidden_states=True).hidden_states
        ours = port.hidden_states(port.project(feats))
    assert len(theirs) == len(ours) == 3
    for a, b in zip(ours, theirs):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-10)
    # under a head model's ``wav2vec2_bert.`` prefix, the head's own tensors not taken
    headed = {**{f"wav2vec2_bert.{k}": v for k, v in state.items()}, "classifier.weight": torch.zeros(2, 4)}
    converted = w2vbert_to_port(state)
    for k, v in w2vbert_to_port(headed).items():
        torch.testing.assert_close(v, converted[k], rtol=0, atol=0)
    with pytest.raises(KeyError):
        w2vbert_to_port({**state, "adapter.layers.0.conv.weight": torch.zeros(1)})


@pytest.mark.parametrize("d,row", [(-65, 0), (-64, 0), (-1, 63), (0, 64), (1, 65), (8, 72), (9, 72), (500, 72),
                                   (-500, 0)])
def test_relative_index_by_hand(d, row):
    # key minus query, clamped to [-64, 8], plus 64: 73 rows
    table = relative_key_index(1001, 64, 8, torch.device("cpu"))
    i = 500
    assert int(table[i, i + d]) == row


def test_relative_index_is_the_reference_formula_and_cached():
    cfg = {"rel_left": 64, "rel_right": 8}
    table = relative_key_index(799, 64, 8, torch.device("cpu"))
    assert torch.equal(table, ref.relative_index(799, cfg))
    assert table is relative_key_index(799, 64, 8, torch.device("cpu"))
    assert torch.unique(table).tolist() == list(range(73))  # at T = 799 every row is used


def test_relative_key_mask_is_q_dot_e_of_the_row():
    g = torch.Generator().manual_seed(1)
    layer = w2v_bert.ConformerLayer(WCFG)
    q = torch.randn(2, 4, 90, 16, generator=g)
    with torch.no_grad():
        mask = layer.relative_key(q)
        e = layer.distance_embedding.weight
        for i, j in [(0, 0), (10, 3), (3, 10), (80, 1), (1, 80), (50, 58), (50, 59)]:
            row = min(max(j - i, -64), 8) + 64
            torch.testing.assert_close(mask[:, :, i, j], q[:, :, i] @ e[row] / 4.0, rtol=1e-6, atol=1e-6)


def test_conv_module_is_causal():
    torch.manual_seed(2)
    conv = ConvModule(WCFG).eval()
    x = torch.randn(2, 60, WCFG.hidden)
    y = x.clone()
    y[:, 40:] += torch.randn(2, 20, WCFG.hidden)  # change frames 40 on
    with torch.no_grad():
        a, b = conv(x), conv(y)
    torch.testing.assert_close(a[:, :40], b[:, :40], rtol=0, atol=0)
    assert float((a[:, 40:] - b[:, 40:]).abs().min()) > 0
    z = x.clone()
    z[:, 9] += 1.0  # frame 9 reaches frames 9 .. 39 alone
    with torch.no_grad():
        c = conv(z)
    torch.testing.assert_close(c[:, :9], a[:, :9], rtol=0, atol=0)
    torch.testing.assert_close(c[:, 40:], a[:, 40:], rtol=0, atol=0)
    assert bool(((c[:, 9:40] - a[:, 9:40]).abs().amax(-1) > 0).all())


def _moved(model, wav, exact) -> float:
    return float((_logits(model, wav) - exact).abs().max())


def test_relative_key_macaron_and_causal_pad_each_move_the_answer(setup, monkeypatch):
    _, wav, model, exact = setup
    assert _moved(model, wav, exact) < FP32_TOL
    with monkeypatch.context() as m:  # the window reversed: query minus key
        index = w2v_bert.relative_key_index
        m.setattr(w2v_bert, "relative_key_index", lambda t, left, right, device: index(t, left, right, device).T)
        assert _moved(model, wav, exact) > 1e-3
    pad = torch.nn.functional.pad
    with monkeypatch.context() as m:  # the depthwise pad centred
        m.setattr(torch.nn.functional, "pad", lambda x, p, *a, **k: pad(x, (15, 15) if tuple(p) == (30, 0) else p,
                                                                          *a, **k))
        assert _moved(model, wav, exact) > 1e-3


def test_published_widths_on_meta():
    assert W2V_BERT_2 == w2v_bert.W2VBertConfig(hidden=1024, heads=16, ffn=4096, layers=24, conv_kernel=31,
                                                rel_left=64, rel_right=8, eps=1e-5)
    with torch.device("meta"):
        model = W2VBertMHFA()
    # transformers' Wav2Vec2BertModel(Wav2Vec2BertConfig()) less masked_spec_embed's 1,024
    assert sum(p.numel() for p in model.w2vbert.parameters()) == 580_492_096
    assert sum(p.numel() for p in model.mhfa.parameters()) == 2_368_628
    bench = read_json(BENCH_DIR / "configs" / "w2vbert-mhfa.json")
    assert system._w2vbert_config(bench) == W2V_BERT_2
    assert e2e.W2VBERT_MHFA_SAMPLES == bench["n_samples"] == 256000
    wav = torch.empty(2, e2e.W2VBERT_MHFA_SAMPLES, device="meta")
    assert model.w2vbert.features(wav).shape == (2, 799, 1024)  # 1,598 Kaldi frames, paired
    # every tensor the benchmark states, by name and shape, and no other
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == system.shapes(bench)


def test_wavlm_mhfa_keeps_its_keys_and_count():
    with torch.device("meta"):
        wavlm, w2v = WavLMMHFA(), W2VBertMHFA()
    assert isinstance(wavlm, SSLMHFA) and isinstance(w2v, SSLMHFA)
    assert wavlm.front_end is wavlm.wavlm and w2v.front_end is w2v.w2vbert
    keys = list(wavlm.state_dict())
    assert keys[0] == "wavlm.conv.convs.0.weight" and keys[-1] == "mhfa.out_layer.bias"
    assert {k.split(".")[0] for k in keys} == {"wavlm", "mhfa"}
    assert sum(p.numel() for p in wavlm.parameters()) == 315_451_968 + 2_368_628
    bench = read_json(BENCH_DIR / "configs" / "wavlm-mhfa.json")
    from portbench.systems import wavlm_mhfa

    assert {k: tuple(v.shape) for k, v in wavlm.state_dict().items()} == wavlm_mhfa.shapes(bench)


def test_scorer_is_the_bona_fide_logit_under_spans(setup):
    _, wav, model, _ = setup
    score = e2e.make_w2vbert_mhfa_scorer(model)
    assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = score(wav)
    with torch.inference_mode():
        torch.testing.assert_close(out, model(wav)[:, 1])
    spans = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
             for e in prof.profiler.kineto_results.events() if e.is_user_annotation()]
    named = {n: [s for s in spans if s[0] == n] for n in {s[0] for s in spans}}
    counts = {"score.call": 1, "score.frontend": 1, "score.model": 1, "w2vbert.fbank": 1, "w2vbert.encoder": 1,
              "w2vbert.rel_key": CFG["layers"], "w2vbert.conv_module": CFG["layers"], "mhfa.pool": 1}
    assert {n: len(v) for n, v in named.items()} == counts
    nest = {"score.frontend": "score.call", "score.model": "score.call", "w2vbert.fbank": "score.frontend",
            "w2vbert.encoder": "score.frontend", "w2vbert.rel_key": "w2vbert.encoder",
            "w2vbert.conv_module": "w2vbert.encoder", "mhfa.pool": "score.model"}
    for inner, outer in nest.items():
        (o,) = named[outer]
        assert all(o[1] <= s[1] and s[2] <= o[2] for s in named[inner]), inner
    fbank, encoder = named["w2vbert.fbank"][0], named["w2vbert.encoder"][0]
    assert fbank[2] <= encoder[1]


def test_score_cli_w2vbert_mhfa_tiles_and_cuts(tmp_path, monkeypatch, capsys):
    d = tmp_path / "audio"
    d.mkdir()
    rng = np.random.default_rng(1)
    clips = {"long.wav": rng.standard_normal(21000) * 0.1, "short.wav": rng.standard_normal(7000) * 0.1}
    for name, y in clips.items():
        write_wav(str(d / name), np.clip(y, -0.99, 0.99), 16000)
    model = tiny_model().eval()
    e2e._init_uniform(model, torch.Generator().manual_seed(2))
    monkeypatch.setattr(e2e, "W2VBERT_MHFA_SAMPLES", 16000)
    monkeypatch.setattr(e2e, "init_w2vbert_mhfa", lambda checkpoint, device: model)
    assert cli_main(["score", str(d), "--model", "w2vbert-mhfa", "--allow-random", "--device", "cpu"]) == 0
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
    assert cli_main(["score", str(d), "--model", "w2vbert-mhfa", "--allow-random", "--device", "cpu",
                     "--sr", "8000"]) == 2


def test_init_takes_a_published_front_end_and_keeps_the_seeded_back_end(tmp_path, monkeypatch):
    monkeypatch.setattr(e2e, "W2VBertMHFA", tiny_model)
    seeded = e2e.init_w2vbert_mhfa(seed=7, device="cpu")
    assert all(float(p.detach().abs().max()) == 0 for p in (seeded.mhfa.weights_k, seeded.mhfa.weights_v))
    layer = seeded.w2vbert.layers[0].requires_grad_(False)
    assert float(layer.ffn1.fc1.bias.abs().max()) == 0  # the published init's zero biases
    assert 0.015 < float(layer.q.weight.std()) < 0.025  # N(0, 0.02)
    assert 0.2 < float(layer.conv_module.depthwise.weight.std()) < 0.3  # Kaiming normal, fan in 31
    assert 0.8 < float(layer.distance_embedding.weight.std()) < 1.2  # N(0, 1)
    g = torch.Generator().manual_seed(4)
    published = {f"wav2vec2_bert.{k}": torch.randn(shape, generator=g) for k, shape in _hf_shapes().items()}
    path = tmp_path / "model.pt"
    torch.save(published, path)
    model = e2e.init_w2vbert_mhfa(checkpoint=str(path), seed=7, device="cpu")
    expected = w2vbert_to_port(published)
    for k, v in model.w2vbert.state_dict().items():
        torch.testing.assert_close(v, expected[k], rtol=0, atol=0, msg=k)
    for k, v in model.mhfa.state_dict().items():
        torch.testing.assert_close(v, seeded.mhfa.state_dict()[k], rtol=0, atol=0, msg=k)
    torch.save(model.state_dict(), tmp_path / "port.pt")
    again = e2e.init_w2vbert_mhfa(checkpoint=str(tmp_path / "port.pt"), seed=8, device="cpu")
    for k, v in again.state_dict().items():
        torch.testing.assert_close(v, model.state_dict()[k], rtol=0, atol=0, msg=k)


def _hf_shapes() -> dict[str, tuple[int, ...]]:
    """The published names and shapes of the tiny front end, written out
    (no ``transformers`` needed): the port's, the pointwise convs with
    their kernel axis, ``masked_spec_embed`` beside them."""
    d, f = WCFG.hidden, WCFG.ffn
    out = {"masked_spec_embed": (d,), "feature_projection.layer_norm.weight": (160,),
           "feature_projection.layer_norm.bias": (160,), "feature_projection.projection.weight": (d, 160),
           "feature_projection.projection.bias": (d,)}
    for i in range(WCFG.layers):
        p = f"encoder.layers.{i}."
        for norm in ("ffn1_layer_norm", "self_attn_layer_norm", "conv_module.layer_norm",
                     "conv_module.depthwise_layer_norm", "ffn2_layer_norm", "final_layer_norm"):
            out.update({p + norm + ".weight": (d,), p + norm + ".bias": (d,)})
        for ffn in ("ffn1", "ffn2"):
            out.update({p + ffn + ".intermediate_dense.weight": (f, d), p + ffn + ".intermediate_dense.bias": (f,),
                        p + ffn + ".output_dense.weight": (d, f), p + ffn + ".output_dense.bias": (d,)})
        for lin in ("linear_q", "linear_k", "linear_v", "linear_out"):
            out.update({p + f"self_attn.{lin}.weight": (d, d), p + f"self_attn.{lin}.bias": (d,)})
        out[p + "self_attn.distance_embedding.weight"] = (73, d // WCFG.heads)
        out[p + "conv_module.pointwise_conv1.weight"] = (2 * d, d, 1)
        out[p + "conv_module.depthwise_conv.weight"] = (d, 1, 31)
        out[p + "conv_module.pointwise_conv2.weight"] = (d, d, 1)
    return out


def test_fbank_takes_grad_after_an_inference_call():
    fb._operands_on.cache_clear()
    wav = waves(2, 4000, 16000, seed_generator(13, "cpu"), "cpu", AUDIO).double()
    with torch.inference_mode():
        first = fb.kaldi_fbank(wav)
    x = wav.clone().requires_grad_()
    again = fb.kaldi_fbank(x)
    (again * torch.linspace(-1, 1, again.shape[-1], dtype=again.dtype)).sum().backward()
    assert torch.equal(first, again.detach())
    assert x.grad is not None and bool(torch.isfinite(x.grad).all()) and float(x.grad.abs().sum()) > 0
