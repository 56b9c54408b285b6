"""Whisper large-v3's encoder + MHFA in the port (``frontend/mel.py::
whisper_log_mel``, ``models/whisper.py``, ``models/mhfa.py``,
``score/e2e.py``, ``convert.whisper_to_port``, ``score --model
whisper-mhfa``), on the CPU.

The port is held to the benchmark's plain reference
(``portbench/reference/whisper_mhfa.py``, plain torch, importing nothing of
the port) at a tiny size (hidden 64, 4 heads, FFN 128, 2 layers, 16 mels,
1-s clips: 100 mel frames, 50 positions; MHFA 8 heads, compression 16, 32
outputs) on the benchmark's seeded, calibrated weights; its log-mel to
transformers' ``WhisperFeatureExtractor`` at the published size and its
encoder to transformers' ``WhisperEncoder``, the published code, which the
build box has (imported with ``USE_TF=0``; the card machine has no
``transformers``, and neither the port nor the reference imports it). The
JAX package has no such model.
"""

import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from audioanalysisdetector_tpu_torch.cli.main import main as cli_main
from audioanalysisdetector_tpu_torch.convert import whisper_to_port
from audioanalysisdetector_tpu_torch.frontend.mel import whisper_log_mel
from audioanalysisdetector_tpu_torch.io.audio import load_audio, write_wav
from audioanalysisdetector_tpu_torch.io.flac import write_flac
from audioanalysisdetector_tpu_torch.models import whisper
from audioanalysisdetector_tpu_torch.models.mhfa import SSLMHFA, WhisperMHFA
from audioanalysisdetector_tpu_torch.models.wav2vec2 import (
    EncoderLayer,
    GatedEncoderLayer,
    WavLMConfig,
    XLSRConfig,
    split_heads,
)
from audioanalysisdetector_tpu_torch.models.whisper import WHISPER_LARGE_V3, WhisperEncoder, sinusoids
from audioanalysisdetector_tpu_torch.score import e2e

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from portbench.harness.audio import seed_generator, waves  # noqa: E402
from portbench.harness.cells import BENCH_DIR, read_json  # noqa: E402
from portbench.reference import whisper_mhfa as ref  # noqa: E402
from portbench.systems import whisper_mhfa as system  # noqa: E402

torch.set_num_threads(2)

TINY = dict(hidden=64, heads=4, ffn=128, layers=2, n_mels=16, positions=50, n_samples=16000, mhfa_heads=8,
            mhfa_compression=16, mhfa_outputs=32, calibration_rows=8)
CFG = {**read_json(BENCH_DIR / "configs" / "whisper-mhfa.json"), **TINY}
WCFG = system._whisper_config(CFG)
AUDIO = read_json(BENCH_DIR / "traffic" / "offline-b16-30s.json")["audio"]
# the port in float32 against the reference in float64, measured at 2.1e-4
# on the logits (std 1.5). At this size the stem's output (rms 0.012) rides
# on sinusoids of rms 0.71, so what differs between utterances is a small
# part of the residual stream, and the calibration scales the output layer
# up to match (weights up to ~800): fp32 rounding of the stream is what it
# amplifies (the float64 port on the float32 log-mel reads 1.8e-6; at the
# published widths the stem's rms is ~0.09)
FP32_TOL = 1e-3
# transformers' extractor computes in float32 (``torch.stft``, float32
# filters and log10): its features differ from the port's float32 chain by
# <= 2e-5 and from a float64 chain by <= 1.4e-5 on values of order 1
# (measured on the build box, seeded 30-s clips)
HF_LOGMEL_TOL = 1e-4


def tiny_model() -> WhisperMHFA:
    return WhisperMHFA(WCFG, CFG["mhfa_heads"], CFG["mhfa_compression"], CFG["mhfa_outputs"])


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
        mel = m64.whisper.features(x)
        assert mel.shape == (6, 16, 100)  # 101 frames of 1 s, the last dropped
        # the port's DFT bases are float32 constants (rounded once, as K1's
        # are), the reference's float64: the features agree to ~5e-8
        torch.testing.assert_close(mel, ref.log_mel(x, CFG).transpose(1, 2), rtol=0, atol=5e-7)
        states = m64.whisper.hidden_states(mel)
        ref_states = ref.hidden_states(x, weights, CFG)
        assert len(states) == len(ref_states) == CFG["layers"] + 1
        for got, want in zip(states, ref_states):  # measured <= 8e-8
            torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
        # the calibrated output layer amplifies that (below): measured 1.8e-6
        torch.testing.assert_close(m64.mhfa(states)[:, 1], exact, rtol=0, atol=1e-5)


def test_tiny_port_matches_reference_in_float32(setup):
    _, wav, model, exact = setup
    assert float((_logits(model, wav) - exact).abs().max()) < FP32_TOL
    assert float(exact.std()) > 0.5  # calibrated logits spread: the comparison sees every path


@pytest.fixture(scope="module")
def transformers_mod():
    os.environ.setdefault("USE_TF", "0")
    os.environ.setdefault("USE_FLAX", "0")
    return pytest.importorskip("transformers")


@pytest.mark.parametrize("seconds", [30.0, 7.0], ids=["30s", "7s-padded"])
def test_log_mel_matches_the_published_extractor(transformers_mod, seconds):
    extractor = transformers_mod.WhisperFeatureExtractor(feature_size=128)
    n = int(seconds * 16000)
    clips = waves(2, n, 16000, seed_generator(11, "cpu"), "cpu", AUDIO)
    padded = F.pad(clips, (0, e2e.WHISPER_MHFA_SAMPLES - n))  # zeros to 30 s, as the extractor pads
    ours = whisper_log_mel(padded, WHISPER_LARGE_V3.mel)
    assert ours.shape == (2, 128, 3000)
    theirs = extractor(list(clips.numpy()), sampling_rate=16000, return_tensors="np")["input_features"]
    np.testing.assert_allclose(ours.numpy(), theirs, rtol=0, atol=HF_LOGMEL_TOL)
    np.testing.assert_allclose(WHISPER_LARGE_V3.mel.filterbank(), extractor.mel_filters.T, rtol=0, atol=1e-12)
    if seconds < 30:  # the silent tail sits at the clip's own floor, max - 8
        floor = ours[:, :, -100:]
        torch.testing.assert_close(floor, (ours.amax(dim=(1, 2), keepdim=True) - 2.0).expand_as(floor))


def _published_encoder(transformers_mod, g: torch.Generator):
    """transformers' ``WhisperEncoder`` at the tiny shape, float64, its
    norms and biases moved off their initial values so each one counts."""
    config = transformers_mod.WhisperConfig(d_model=64, encoder_layers=2, encoder_attention_heads=4,
                                            encoder_ffn_dim=128, num_mel_bins=16, max_source_positions=50)
    model = transformers_mod.models.whisper.modeling_whisper.WhisperEncoder(config).double().eval()
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "layer_norm" in name or name.endswith(".bias"):
                p.add_(0.1 * torch.randn(p.shape, generator=g, dtype=p.dtype))
    return model


def test_encoder_matches_the_published_model(transformers_mod):
    g = torch.Generator().manual_seed(3)
    published = _published_encoder(transformers_mod, g)
    port = WhisperEncoder(WCFG).double().eval()
    state = published.state_dict()
    assert not any(k.endswith("k_proj.bias") for k in state)
    port.load_state_dict(whisper_to_port(state))  # strict: every tensor placed, none left over
    torch.testing.assert_close(port.positions, sinusoids(50, 64).double(), rtol=0, atol=1e-4)
    feats = torch.randn(2, 16, 100, generator=g, dtype=torch.float64)
    with torch.no_grad():
        theirs = published(feats, output_hidden_states=True).hidden_states
        ours = port.hidden_states(feats)
    assert len(theirs) == len(ours) == 3
    for a, b in zip(ours, theirs):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-10)
    with pytest.raises(ValueError):
        port.hidden_states(feats[..., :98])  # 49 positions: Whisper takes exactly 50, as published
    # under WhisperModel's ``encoder.`` and WhisperForConditionalGeneration's
    # ``model.encoder.`` prefixes, the decoder's tensors not taken
    converted = whisper_to_port(state)
    for prefix in ("encoder.", "model.encoder."):
        headed = {**{prefix + k: v for k, v in state.items()},
                  prefix.replace("encoder", "decoder") + "embed_tokens.weight": torch.zeros(3, 4),
                  "proj_out.weight": torch.zeros(3, 4)}
        got = whisper_to_port(headed)
        assert got.keys() == converted.keys()
        for k, v in got.items():
            torch.testing.assert_close(v, converted[k], rtol=0, atol=0)
    with pytest.raises(KeyError):
        whisper_to_port({**state, "layers.0.self_attn.rotary.weight": torch.zeros(1)})


def test_sinusoids_by_hand():
    table = sinusoids(1500, 1280)
    assert table.shape == (1500, 1280) and table.dtype == torch.float32
    w = np.exp(-np.log(10000.0) / 639 * np.arange(640))
    for t, i in [(0, 0), (1, 0), (1499, 0), (7, 5), (1499, 639), (300, 320)]:
        assert float(table[t, i]) == pytest.approx(np.sin(t * w[i]), abs=1e-7)
        assert float(table[t, 640 + i]) == pytest.approx(np.cos(t * w[i]), abs=1e-7)
    torch.testing.assert_close(table, ref.sinusoids(1500, 1280, CFG, torch.empty(0, dtype=torch.float64)).float(),
                               rtol=0, atol=0)


def test_published_widths_on_meta():
    assert WHISPER_LARGE_V3 == whisper.WhisperConfig(hidden=1280, heads=20, ffn=5120, layers=32, positions=1500,
                                                     eps=1e-5)
    with torch.device("meta"):
        model = WhisperMHFA()
    assert isinstance(model, SSLMHFA) and model.front_end is model.whisper
    # transformers' WhisperEncoder(whisper-large-v3's config), its positions' table among them
    assert sum(p.numel() for p in model.whisper.parameters()) == 636_968_960
    assert sum(p.numel() for p in model.mhfa.parameters()) == 2_434_180
    assert model.mhfa.weights_k.shape == (33,) and model.mhfa.cmp_linear_k.in_features == 1280
    assert all(layer.k.bias is None and layer.q.bias is not None for layer in model.whisper.layers)
    assert not model.whisper.positions.requires_grad
    bench = read_json(BENCH_DIR / "configs" / "whisper-mhfa.json")
    assert system._whisper_config(bench) == WHISPER_LARGE_V3
    assert e2e.WHISPER_MHFA_SAMPLES == bench["n_samples"] == 480000
    mel = torch.empty(2, 128, 3000, device="meta")
    states = model.whisper.hidden_states(mel)
    assert len(states) == 33 and all(s.shape == (2, 1500, 1280) for s in states)
    # every tensor the benchmark states, by name and shape, and no other
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == system.shapes(bench)


def _parent_layer_forward(layer: EncoderLayer, h: torch.Tensor, bias: torch.Tensor | None) -> torch.Tensor:
    """``EncoderLayer.forward`` as it stood before Whisper's layer shared it,
    written out op for op."""
    d = h.shape[-1]
    x = F.layer_norm(h, (d,), layer.attn_norm.weight, layer.attn_norm.bias, layer.attn_norm.eps)
    mask = layer.attention_bias(x, bias)
    n = layer.heads
    q, k, v = (split_heads(F.linear(x, m.weight, m.bias), n) for m in (layer.q, layer.k, layer.v))
    a = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
    h = h + F.linear(a.transpose(1, 2).reshape(h.shape), layer.out.weight, layer.out.bias)
    y = F.layer_norm(h, (d,), layer.ffn_norm.weight, layer.ffn_norm.bias, layer.ffn_norm.eps)
    return h + F.linear(F.gelu(F.linear(y, layer.fc1.weight, layer.fc1.bias)), layer.fc2.weight, layer.fc2.bias)


@pytest.mark.parametrize("kind", ["xlsr", "wavlm"])
def test_shared_layer_keeps_xlsr_and_wavlm_bitwise(kind):
    torch.manual_seed(5)
    if kind == "xlsr":
        layer, bias = EncoderLayer(XLSRConfig(hidden=64, heads=4, ffn=128)), None
    else:
        layer, bias = GatedEncoderLayer(WavLMConfig(hidden=64, heads=4, ffn=128)), torch.randn(4, 30, 30)
    keys = ["attn_norm.weight", "attn_norm.bias", "q.weight", "q.bias", "k.weight", "k.bias", "v.weight", "v.bias",
            "out.weight", "out.bias", "ffn_norm.weight", "ffn_norm.bias", "fc1.weight", "fc1.bias", "fc2.weight",
            "fc2.bias"]
    assert [k for k in layer.state_dict() if k in keys] == keys  # k keeps its bias
    h = torch.randn(3, 30, 64)
    with torch.no_grad():
        assert torch.equal(layer(h, bias), _parent_layer_forward(layer, h, bias))


def test_k_bias_is_softmax_invariant():
    """A bias on ``k`` adds ``q . b`` to every key of a query alike, which
    the softmax cancels: Whisper dropped it for that reason, and no
    comparison can see it (``test_portbench_whisper.py`` records the
    reading)."""
    torch.manual_seed(6)
    layer = whisper.WhisperLayer(WCFG)
    biased = EncoderLayer(WCFG)
    biased.load_state_dict({**layer.state_dict(), "k.bias": torch.randn(64)})
    h = torch.randn(2, 50, 64)
    with torch.no_grad():
        torch.testing.assert_close(biased(h), layer(h), rtol=1e-5, atol=1e-5)


def test_scorer_is_the_bona_fide_logit_under_spans(setup):
    _, wav, model, _ = setup
    score = e2e.make_whisper_mhfa_scorer(model)
    assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = score(wav)
    with torch.inference_mode():
        torch.testing.assert_close(out, model(wav)[:, 1])
    spans = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
             for e in prof.profiler.kineto_results.events() if e.is_user_annotation()]
    named = {n: [s for s in spans if s[0] == n] for n in {s[0] for s in spans}}
    counts = {"score.call": 1, "score.frontend": 1, "score.model": 1, "whisper.log_mel": 1, "mel.pad": 0,
              "whisper.encoder": 1, "whisper.conv_stem": 1, "ssl.attend": CFG["layers"], "mhfa.pool": 1}
    assert {n: len(v) for n, v in named.items()} == {n: c for n, c in counts.items() if c}
    nest = {"score.frontend": "score.call", "score.model": "score.call", "whisper.log_mel": "score.frontend",
            "whisper.encoder": "score.frontend", "whisper.conv_stem": "whisper.encoder",
            "ssl.attend": "whisper.encoder", "mhfa.pool": "score.model"}
    for inner, outer in nest.items():
        (o,) = named[outer]
        assert all(o[1] <= s[1] and s[2] <= o[2] for s in named[inner]), inner
    log_mel, stem = named["whisper.log_mel"][0], named["whisper.conv_stem"][0]
    assert log_mel[2] <= stem[1] and all(stem[2] <= s[1] for s in named["ssl.attend"])


def test_log_mel_takes_k1_on_the_card_route(monkeypatch):
    """On a CUDA tensor the log-mel is one ``wave_mel_unpadded`` call (K1,
    its center pad under ``mel.pad``): ``mel_route`` sends n_fft 400 to K1,
    and no plain chain runs. Checked here with a fake card tensor's route."""
    from audioanalysisdetector_tpu_torch.frontend import mel as mel_mod
    from audioanalysisdetector_tpu_torch.ops import wave_mel as k1

    assert mel_mod.mel_route(WHISPER_LARGE_V3.mel) == "wave_mel"
    calls = []
    wav = waves(2, 480000, 16000, seed_generator(9, "cpu"), "cpu", AUDIO)
    want = whisper_log_mel(wav, WHISPER_LARGE_V3.mel)
    power = k1.wave_mel_unpadded(wav, WHISPER_LARGE_V3.mel)  # K1's plain version: (B, 3001, 128)

    def fake_k1(y, cfg):
        calls.append((tuple(y.shape), cfg))
        return power
    monkeypatch.setattr(k1, "wave_mel_unpadded", fake_k1)
    monkeypatch.setattr(mel_mod, "power_spectrogram", lambda *a, **k: pytest.fail("the plain chain ran"))
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    got = whisper_log_mel(wav, WHISPER_LARGE_V3.mel)
    monkeypatch.undo()
    assert calls == [((2, 480000), WHISPER_LARGE_V3.mel)]
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_score_cli_whisper_mhfa_pads_with_zeros_and_cuts(tmp_path, monkeypatch, capsys):
    d = tmp_path / "audio"
    d.mkdir()
    rng = np.random.default_rng(1)
    clips = {"long.flac": rng.standard_normal(21000) * 0.1, "short.flac": rng.standard_normal(7000) * 0.1,
             "short.wav": rng.standard_normal(5000) * 0.1}
    for name, y in clips.items():
        (write_flac if name.endswith(".flac") else write_wav)(str(d / name), np.clip(y, -0.99, 0.99), 16000)
    model = tiny_model().eval()
    e2e._init_uniform(model, torch.Generator().manual_seed(2))
    monkeypatch.setattr(e2e, "WHISPER_MHFA_SAMPLES", 16000)
    monkeypatch.setattr(e2e, "init_whisper_mhfa", lambda checkpoint, device: model)
    assert cli_main(["score", str(d), "--model", "whisper-mhfa", "--allow-random", "--device", "cpu"]) == 0
    lines = [json.loads(s) for s in capsys.readouterr().out.strip().splitlines()]
    assert [Path(x["file"]).name for x in lines] == sorted(clips)
    assert all(set(x) == {"file", "bonafide_logit"} for x in lines)
    rows = []
    for name in sorted(clips):
        y = load_audio(str(d / name), sr=16000)[0]
        row = np.zeros(16000, np.float32)
        row[:min(len(y), 16000)] = y[:16000]  # trimmed, or zero-padded: no tiling
        rows.append(row)
    with torch.inference_mode():
        want = model(torch.from_numpy(np.stack(rows)))[:, 1].numpy()
    np.testing.assert_allclose([x["bonafide_logit"] for x in lines], want, rtol=0, atol=1e-5)
    assert cli_main(["score", str(d), "--model", "whisper-mhfa", "--allow-random", "--device", "cpu",
                     "--sr", "8000"]) == 2


def _hf_shapes() -> dict[str, tuple[int, ...]]:
    """The published names and shapes of the tiny encoder under
    ``model.encoder.``, written out (no ``transformers`` needed), beside a
    decoder tensor and ``proj_out``."""
    d, f = WCFG.hidden, WCFG.ffn
    p = "model.encoder."
    out = {p + "conv1.weight": (d, 16, 3), p + "conv1.bias": (d,), p + "conv2.weight": (d, d, 3),
           p + "conv2.bias": (d,), p + "embed_positions.weight": (50, d), p + "layer_norm.weight": (d,),
           p + "layer_norm.bias": (d,), "model.decoder.embed_tokens.weight": (10, d), "proj_out.weight": (10, d)}
    for i in range(WCFG.layers):
        q = f"{p}layers.{i}."
        for norm in ("self_attn_layer_norm", "final_layer_norm"):
            out.update({q + norm + ".weight": (d,), q + norm + ".bias": (d,)})
        for lin in ("q_proj", "v_proj", "out_proj"):
            out.update({q + f"self_attn.{lin}.weight": (d, d), q + f"self_attn.{lin}.bias": (d,)})
        out[q + "self_attn.k_proj.weight"] = (d, d)
        out.update({q + "fc1.weight": (f, d), q + "fc1.bias": (f,), q + "fc2.weight": (d, f), q + "fc2.bias": (d,)})
    return out


def test_init_takes_a_published_encoder_and_keeps_the_seeded_back_end(tmp_path, monkeypatch):
    monkeypatch.setattr(e2e, "WhisperMHFA", tiny_model)
    seeded = e2e.init_whisper_mhfa(seed=7, device="cpu")
    assert all(float(p.detach().abs().max()) == 0 for p in (seeded.mhfa.weights_k, seeded.mhfa.weights_v))
    layer = seeded.whisper.layers[0].requires_grad_(False)
    assert float(layer.fc1.bias.abs().max()) == 0  # the published init's zero biases
    assert 0.015 < float(layer.q.weight.std()) < 0.025  # N(0, 0.02)
    assert 0.015 < float(seeded.whisper.conv2.weight.detach().std()) < 0.025
    torch.testing.assert_close(seeded.whisper.positions, sinusoids(50, 64), rtol=0, atol=0)
    g = torch.Generator().manual_seed(4)
    published = {k: torch.randn(shape, generator=g) for k, shape in _hf_shapes().items()}
    path = tmp_path / "model.pt"
    torch.save(published, path)
    model = e2e.init_whisper_mhfa(checkpoint=str(path), seed=7, device="cpu")
    expected = whisper_to_port(published)
    for k, v in model.whisper.state_dict().items():
        torch.testing.assert_close(v, expected[k], rtol=0, atol=0, msg=k)
    for k, v in model.mhfa.state_dict().items():
        torch.testing.assert_close(v, seeded.mhfa.state_dict()[k], rtol=0, atol=0, msg=k)
    torch.save(model.state_dict(), tmp_path / "port.pt")
    again = e2e.init_whisper_mhfa(checkpoint=str(tmp_path / "port.pt"), seed=8, device="cpu")
    for k, v in again.state_dict().items():
        torch.testing.assert_close(v, model.state_dict()[k], rtol=0, atol=0, msg=k)
