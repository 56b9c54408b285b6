"""Voxtral-Mini-3B read as a detector in the port (``frontend/mel.py::
whisper_log_mel_windows``, ``models/voxtral.py``, ``models/whisper.py::
last_state``, ``score/e2e.py``, ``convert.voxtral_to_port``, ``score
--model voxtral-detect``), on the CPU.

The port is held to transformers' ``VoxtralForConditionalGeneration``, the
published code, which the build box has (imported with ``USE_TF=0``; the
card machine has no ``transformers``, and neither the port nor the
reference imports it), at a tiny seeded size with 2 windows a clip (40
positions a window, 128 mel bins, a tower of 64) and real grouped-query
attention (8 query heads over 2 KV heads of 16, q 128 wide against a
hidden size of 64); and to the
benchmark's plain reference (``portbench/reference/voxtral_detect.py``,
plain torch, importing nothing of the port) on the benchmark's seeded,
calibrated weights. The JAX package has no such model.
"""

import json
import os
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from audioanalysisdetector_tpu_torch.cli.main import main as cli_main
from audioanalysisdetector_tpu_torch.convert import voxtral_to_port, whisper_to_port
from audioanalysisdetector_tpu_torch.frontend.mel import MelConfig, whisper_log_mel, whisper_log_mel_windows
from audioanalysisdetector_tpu_torch.io.audio import load_audio, write_wav
from audioanalysisdetector_tpu_torch.io.flac import write_flac
from audioanalysisdetector_tpu_torch.models import voxtral
from audioanalysisdetector_tpu_torch.models.voxtral import VOXTRAL_MINI_3B, VoxtralConfig, VoxtralDetector
from audioanalysisdetector_tpu_torch.models.whisper import WHISPER_LARGE_V3, WhisperConfig, WhisperEncoder
from audioanalysisdetector_tpu_torch.score import e2e

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from portbench.harness.audio import seed_generator, waves  # noqa: E402
from portbench.harness.cells import BENCH_DIR, read_json  # noqa: E402
from portbench.reference import voxtral_detect as ref  # noqa: E402
from portbench.systems import voxtral_detect as system  # noqa: E402

torch.set_num_threads(2)

TINY = dict(hidden=64, heads=4, ffn=256, layers=2, n_mels=128, positions=40, window_frames=80, n_samples=25600,
            lm_hidden=64, lm_heads=8, lm_kv_heads=2, lm_head_dim=16, lm_ffn=96, lm_layers=2, vocab=2000,
            calibration_rows=4)
CFG = {**read_json(BENCH_DIR / "configs" / "voxtral-detect.json"), **TINY}
VCFG = system.voxtral_config(CFG)
AUDIO = read_json(BENCH_DIR / "traffic" / "offline-b2-300s.json")["audio"]
# the port in float32 against the reference in float64, measured at 8.9e-5
# to 2.3e-4 over six seeds on scores of std 1.5 or more. At this size what
# differs between clips is a small part of the last position's state (the
# audio reaches it through two layers of attention over 40 positions), so
# the calibration scales the answer rows' difference up (norm 170-660) to
# give the scores their spread, and float32 rounding of the state is what it
# amplifies. The tiny tower keeps the published 128 mel bins: at 16 the
# stem's input is weaker still and the same seeds read up to 1.8e-3
FP32_TOL = 1e-3
# the float64 port against the float64 reference, measured at 5.4e-7 to
# 2.7e-6: the port's DFT bases and filters are float32 constants (K1's),
# which moves the log-mel by ~5e-8, amplified as above
FP64_TOL = 2e-5
# transformers' extractor computes in float32 (``torch.stft``, float32
# filters and log10): its features differ from the port's float32 chain by
# <= 2e-5 on values of order 1 (``test_torch_whisper_mhfa.py``)
HF_LOGMEL_TOL = 1e-4


def tiny_model() -> VoxtralDetector:
    return VoxtralDetector(VCFG)


@pytest.fixture(scope="module")
def setup():
    g = seed_generator(2**31 + 5, "cpu")
    weights = system.make_weights(CFG, g, "cpu", AUDIO)
    wav = waves(6, CFG["n_samples"], CFG["sr"], g, "cpu", AUDIO)
    model = tiny_model().eval()
    model.load_state_dict(weights)
    return weights, wav, model, ref.scores(CFG, weights, wav, aux={})


def test_tiny_port_matches_reference_in_float64(setup):
    weights, wav, _, exact = setup
    m64 = tiny_model().double().eval()
    m64.load_state_dict(weights)
    x = wav.double()
    with torch.no_grad():
        mel = m64.features(x)
        assert mel.shape == (6, 2, 128, 80)  # 2 windows of 80 frames from one log-mel of 161 frames
        # the port's DFT bases are float32 constants (rounded once, as K1's
        # are), the reference's float64; 45 of the 128 filters hold a single
        # 40-Hz bin, whose power in a quiet frame carries that rounding:
        # measured 3.7e-6 (5e-8 at 16 bins)
        torch.testing.assert_close(mel.transpose(2, 3), ref.windows(x, CFG), rtol=0, atol=1e-5)
        torch.testing.assert_close(m64(x), exact, rtol=0, atol=FP64_TOL)


def test_tiny_port_matches_reference_in_float32(setup):
    _, wav, model, exact = setup
    with torch.inference_mode():
        got = model(wav).double()
    assert float((got - exact).abs().max()) < FP32_TOL
    assert float(exact.std()) > 0.5  # calibrated scores spread: the comparison sees every path


@pytest.fixture(scope="module")
def transformers_mod():
    os.environ.setdefault("USE_TF", "0")
    os.environ.setdefault("USE_FLAX", "0")
    return pytest.importorskip("transformers")


def _published(transformers_mod):
    """transformers' ``VoxtralForConditionalGeneration`` at the tiny shape,
    float64, its norms and biases moved off their initial values so each
    one counts."""
    g = torch.Generator().manual_seed(3)
    config = transformers_mod.VoxtralConfig(
        audio_config=dict(hidden_size=64, intermediate_size=256, num_hidden_layers=2, num_attention_heads=4,
                          num_mel_bins=128, max_source_positions=40),
        text_config=dict(hidden_size=64, intermediate_size=96, num_hidden_layers=2, num_attention_heads=8,
                         num_key_value_heads=2, head_dim=16, vocab_size=2000),
        audio_token_id=24)
    model = transformers_mod.VoxtralForConditionalGeneration(config).double().eval()
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "norm" in name or name.endswith(".bias"):
                p.add_(0.1 * torch.randn(p.shape, generator=g, dtype=p.dtype))
    return model


PROMPT = {"prefix_ids": torch.tensor([1101, 1102, 1103, 1104]), "suffix_ids": torch.arange(1200, 1216),
          "answer_ids": torch.tensor([1007, 1009])}


def test_port_matches_the_published_model(transformers_mod):
    published = _published(transformers_mod)
    port = tiny_model().double().eval()
    port.load_state_dict({**voxtral_to_port(published.state_dict()), **PROMPT})  # strict
    g = torch.Generator().manual_seed(4)
    b, w = 2, 2
    feats = torch.randn(b * w, 128, 80, generator=g, dtype=torch.float64)  # (B W, mels, frames), as the processor
    ids = port.prompt_ids(w * 10).expand(b, -1)
    with torch.no_grad():
        out = published(input_ids=ids, input_features=feats, logits_to_keep=1)
        audio = published.get_audio_features(feats)  # (B W 10, 64)
        tower = published.audio_tower(feats).last_hidden_state
        states = port.encode(feats.view(b, w, 128, 80))
        # the encoder's final state, and the projector over 4-frame groups
        torch.testing.assert_close(states, tower.reshape(b, w * 40, 64), rtol=0, atol=1e-10)
        torch.testing.assert_close(port.projector(states), audio.view(b, w * 10, 64), rtol=0, atol=1e-10)
        theirs = out.logits[:, -1, PROMPT["answer_ids"]]
        # transformers computes RoPE's angles in float32 (the port in float64,
        # rounded once): the margins agree to ~1e-8
        torch.testing.assert_close(port.answer(states), theirs[:, 0] - theirs[:, 1], rtol=0, atol=1e-6)
        assert out.logits.shape == (b, 1, 2000)  # logits_to_keep=1, as the port's head


def test_rope_is_rotate_half_at_theta_1e8():
    cos, sin = voxtral.rope_tables(3770, 128, 1e8, torch.device("cpu"), torch.float64)
    for p, i in [(0, 0), (1, 0), (3769, 0), (7, 5), (3769, 63), (300, 32)]:
        angle = p * 1e8 ** (-2 * i / 128)
        for half in (0, 64):  # the two halves of a head share the angle
            assert float(cos[p, i + half]) == pytest.approx(np.cos(angle), abs=1e-12)
            assert float(sin[p, i + half]) == pytest.approx(np.sin(angle), abs=1e-12)
    x = torch.randn(1, 1, 3770, 128, dtype=torch.float64)
    y = voxtral.apply_rope(x, cos, sin)
    for p, i in [(5, 3), (3000, 40)]:
        c, s = float(cos[p, i]), float(sin[p, i])
        a, b = float(x[0, 0, p, i]), float(x[0, 0, p, i + 64])  # pair (i, i + 64) turns by the angle
        assert float(y[0, 0, p, i]) == pytest.approx(a * c - b * s, abs=1e-12)
        assert float(y[0, 0, p, i + 64]) == pytest.approx(b * c + a * s, abs=1e-12)
    q = ref.rope(x, {"rope_theta": 1e8})
    torch.testing.assert_close(y, q, rtol=0, atol=1e-9)


def _explicit(q, k, v, kv_of):
    """Causal softmax attention with query head h reading KV head kv_of[h]."""
    t = q.shape[2]
    s = q @ k[:, kv_of].transpose(-1, -2) / q.shape[-1] ** 0.5
    s = s.masked_fill(torch.ones(t, t, dtype=torch.bool).triu(1), float("-inf"))
    return (torch.softmax(s, -1) @ v[:, kv_of]).transpose(1, 2).flatten(2)


def test_gqa_groups_four_query_heads_on_each_kv_head():
    g = torch.Generator().manual_seed(6)
    q = torch.randn(2, 32, 9, 8, generator=g, dtype=torch.float64)
    k, v = (torch.randn(2, 8, 9, 8, generator=g, dtype=torch.float64) for _ in range(2))
    got = voxtral.lm_attend(q, k, v)
    torch.testing.assert_close(got, _explicit(q, k, v, torch.arange(32) // 4), rtol=0, atol=1e-12)
    tiled = _explicit(q, k, v, torch.arange(32) % 8)  # KV heads tiled, not grouped
    assert float((got - tiled).abs().max()) > 0.1
    # the causal mask: the first query reads the first key alone
    torch.testing.assert_close(got[:, 0].view(2, 32, 8), v[:, torch.arange(32) // 4, 0], rtol=0, atol=1e-12)


def test_decoder_is_causal_a_prefix_reads_as_the_whole(setup):
    weights, wav, _, _ = setup
    model = tiny_model().double().eval()
    model.load_state_dict(weights)
    with torch.no_grad():
        x = model.embed_prompt(model.projector(model.encode(model.features(wav[:2].double()))))
        whole = model.decode(x)
        for k in (1, 5, 27, x.shape[1] - 1):
            torch.testing.assert_close(model.decode(x[:, :k])[:, -1], whole[:, k - 1], rtol=0, atol=1e-12)


def test_whole_clip_log_mel_is_the_processors(transformers_mod):
    """``whisper_log_mel_windows`` against ``WhisperFeatureExtractor`` under
    ``VoxtralProcessor``'s audio settings and its reshape into windows (its
    own ``_retrieve_input_features``), on a 45-s clip padded to 60 s whose
    first window is loud and second quiet: the second window's frames clip
    at the whole clip's max - 8, and its edge frames read across the edge."""
    from transformers.models.voxtral.processing_voxtral import VoxtralProcessor

    extractor = transformers_mod.WhisperFeatureExtractor(feature_size=128)
    clip = waves(1, 720000, 16000, seed_generator(12, "cpu"), "cpu", AUDIO)[0]
    clip[480000:] *= 1e-4
    processor = SimpleNamespace(feature_extractor=extractor)
    theirs = VoxtralProcessor._retrieve_input_features(
        processor, [clip.numpy()], 3000, sampling_rate=16000, padding=True, truncation=False,
        pad_to_multiple_of=480000, return_tensors="pt")
    assert theirs.shape == (2, 128, 3000)
    padded = F.pad(clip, (0, 960000 - 720000))[None]
    ours = whisper_log_mel_windows(padded, WHISPER_LARGE_V3.mel, 3000)
    assert ours.shape == (1, 2, 128, 3000)
    np.testing.assert_allclose(ours[0].numpy(), theirs.numpy(), rtol=0, atol=HF_LOGMEL_TOL)
    # windows cut one by one differ: each its own max, and reflect padding at each edge
    alone = whisper_log_mel(padded.view(2, 480000), WHISPER_LARGE_V3.mel)
    floor = float(ours.amax()) - 2.0
    assert float(ours[0, 1].min()) == pytest.approx(floor, abs=1e-6)
    assert float(alone[1].min()) < floor - 0.5
    edge = (alone[0, :, -1] - ours[0, 0, :, -1]).abs().max()
    assert float(edge) > 1e-3 and float((alone[0, :, 1:-2] - ours[0, 0, :, 1:-2]).abs().max()) < 1e-5


def test_log_mel_is_one_k1_launch_on_the_card_route(monkeypatch):
    """On a CUDA tensor the whole-clip log-mel is one ``wave_mel_unpadded``
    call over the B clips (K1), and no plain chain runs. Checked here with a
    fake card tensor's route."""
    from audioanalysisdetector_tpu_torch.frontend import mel as mel_mod
    from audioanalysisdetector_tpu_torch.ops import wave_mel as k1

    cfg = WHISPER_LARGE_V3.mel
    wav = waves(2, 960000, 16000, seed_generator(9, "cpu"), "cpu", AUDIO)
    want = whisper_log_mel_windows(wav, cfg, 3000)
    power = k1.wave_mel_unpadded(wav, cfg)  # K1's plain version: (B, 6001, 128)
    calls = []

    def fake_k1(y, c):
        calls.append((tuple(y.shape), c))
        return power
    monkeypatch.setattr(k1, "wave_mel_unpadded", fake_k1)
    monkeypatch.setattr(mel_mod, "power_spectrogram", lambda *a, **k: pytest.fail("the plain chain ran"))
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    got = whisper_log_mel_windows(wav, cfg, 3000)
    monkeypatch.undo()
    assert calls == [((2, 960000), cfg)]
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    with pytest.raises(ValueError):
        whisper_log_mel_windows(wav[:, :700000], cfg, 3000)  # not a whole number of windows


def test_last_state_is_the_last_hidden_state():
    torch.manual_seed(7)
    enc = WhisperEncoder(VCFG.audio).eval()
    mel = torch.randn(3, 128, 80)
    with torch.no_grad():
        torch.testing.assert_close(enc.last_state(mel), enc.hidden_states(mel)[-1], rtol=0, atol=0)


def test_work_counts_a_call(setup):
    _, wav, model, _ = setup
    voxtral.reset_work_counts()
    with torch.inference_mode():
        model(wav[:3])
        model(wav[:2])
    t = 4 + 2 * 10 + 16
    assert voxtral.work_counts() == {"voxtral.calls": 2, "voxtral.windows": 5 * 2, "voxtral.positions": 5 * t}
    voxtral.reset_work_counts()
    assert set(voxtral.work_counts().values()) == {0}


def test_scorer_is_the_answer_margin_under_spans(setup):
    _, wav, model, _ = setup
    score = e2e.make_voxtral_detect_scorer(model)
    assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = score(wav)
    with torch.inference_mode():
        torch.testing.assert_close(out, model(wav))
    spans = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
             for e in prof.profiler.kineto_results.events() if e.is_user_annotation()]
    named = {n: [s for s in spans if s[0] == n] for n in {s[0] for s in spans}}
    counts = {"score.call": 1, "score.frontend": 1, "score.model": 1, "whisper.log_mel": 1,
              "whisper.encoder": 1, "whisper.conv_stem": 1, "ssl.attend": CFG["layers"], "voxtral.projector": 1,
              "voxtral.decoder": 1, "lm.attend": CFG["lm_layers"], "voxtral.head": 1}
    assert {n: len(v) for n, v in named.items()} == counts
    nest = {"score.frontend": "score.call", "score.model": "score.call", "whisper.log_mel": "score.frontend",
            "whisper.encoder": "score.frontend", "whisper.conv_stem": "whisper.encoder",
            "ssl.attend": "whisper.encoder", "voxtral.projector": "score.model", "voxtral.decoder": "score.model",
            "lm.attend": "voxtral.decoder", "voxtral.head": "score.model"}
    for inner, outer in nest.items():
        (o,) = named[outer]
        assert all(o[1] <= s[1] and s[2] <= o[2] for s in named[inner]), inner
    assert named["voxtral.decoder"][0][2] <= named["voxtral.head"][0][1]


def test_published_widths_on_meta():
    bench = read_json(BENCH_DIR / "configs" / "voxtral-detect.json")
    assert system.voxtral_config(bench) == VOXTRAL_MINI_3B
    assert VOXTRAL_MINI_3B.audio == WHISPER_LARGE_V3
    with torch.device("meta"):
        model = VoxtralDetector()
    # transformers' VoxtralForConditionalGeneration(Voxtral-Mini-3B's config): 4.68 B
    assert sum(p.numel() for p in model.parameters()) == 4_676_271_104
    assert sum(p.numel() for p in model.whisper.parameters()) == 636_968_960
    assert sum(p.numel() for p in model.projector.parameters()) == 25_165_824
    assert sum(p.numel() for p in model.layers.parameters()) == 3_208_826_880
    assert model.window_samples == bench["pad_to_multiple_of"] == 480000
    # every tensor the benchmark states, by name and shape, and the prompt's ids
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    ids = {"prefix_ids": (4,), "suffix_ids": (16,), "answer_ids": (2,)}
    assert shapes == {**system.shapes(bench), **ids}
    mel = torch.empty(2, 10, 128, 3000, device="meta")
    states = model.encode(mel)
    assert states.shape == (2, 15000, 1280)
    x = model.embed_prompt(model.projector(states))
    assert x.shape == (2, 3770, 3072)
    assert model.head(model.decode(x)).shape == (2,)


def _hf_names(cfg: VoxtralConfig) -> dict[str, tuple[int, ...]]:
    """The published names and shapes at ``cfg``, written out (no
    ``transformers`` needed)."""
    a, d = cfg.audio, cfg.hidden
    out = {"audio_tower.conv1.weight": (a.hidden, a.mel.n_mels, 3), "audio_tower.conv1.bias": (a.hidden,),
           "audio_tower.conv2.weight": (a.hidden, a.hidden, 3), "audio_tower.conv2.bias": (a.hidden,),
           "audio_tower.embed_positions.weight": (a.positions, a.hidden),
           "audio_tower.layer_norm.weight": (a.hidden,), "audio_tower.layer_norm.bias": (a.hidden,),
           "multi_modal_projector.linear_1.weight": (d, a.ffn), "multi_modal_projector.linear_2.weight": (d, d),
           "language_model.model.embed_tokens.weight": (cfg.vocab, d), "language_model.model.norm.weight": (d,),
           "language_model.lm_head.weight": (cfg.vocab, d)}
    for i in range(a.layers):
        p = f"audio_tower.layers.{i}."
        for norm in ("self_attn_layer_norm", "final_layer_norm"):
            out.update({p + norm + ".weight": (a.hidden,), p + norm + ".bias": (a.hidden,)})
        for lin in ("q_proj", "v_proj", "out_proj"):
            out.update({p + f"self_attn.{lin}.weight": (a.hidden, a.hidden), p + f"self_attn.{lin}.bias": (a.hidden,)})
        out[p + "self_attn.k_proj.weight"] = (a.hidden, a.hidden)
        out.update({p + "fc1.weight": (a.ffn, a.hidden), p + "fc1.bias": (a.ffn,), p + "fc2.weight": (a.hidden, a.ffn),
                    p + "fc2.bias": (a.hidden,)})
    q, kv = cfg.heads * cfg.head_dim, cfg.kv_heads * cfg.head_dim
    for i in range(cfg.layers):
        p = f"language_model.model.layers.{i}."
        out.update({p + "input_layernorm.weight": (d,), p + "post_attention_layernorm.weight": (d,),
                    p + "self_attn.q_proj.weight": (q, d), p + "self_attn.k_proj.weight": (kv, d),
                    p + "self_attn.v_proj.weight": (kv, d), p + "self_attn.o_proj.weight": (d, q),
                    p + "mlp.gate_proj.weight": (cfg.ffn, d), p + "mlp.up_proj.weight": (cfg.ffn, d),
                    p + "mlp.down_proj.weight": (d, cfg.ffn)})
    return out


def test_converter_maps_every_published_tensor():
    g = torch.Generator().manual_seed(8)
    published = {k: torch.randn(s, generator=g) for k, s in _hf_names(VCFG).items()}
    port = voxtral_to_port(published)
    model = tiny_model()
    missing, unexpected = model.load_state_dict(port, strict=False)
    assert sorted(missing) == ["answer_ids", "prefix_ids", "suffix_ids"] and not unexpected
    assert torch.equal(port["layers.1.gate.weight"], published["language_model.model.layers.1.mlp.gate_proj.weight"])
    assert torch.equal(port["whisper.positions"], published["audio_tower.embed_positions.weight"])
    tower = {k[len("audio_tower."):]: v for k, v in published.items() if k.startswith("audio_tower.")}
    assert {"whisper." + k for k in whisper_to_port(tower)} <= set(port)
    # the head under a bare ``lm_head.`` maps alike
    bare = {("lm_head.weight" if k == "language_model.lm_head.weight" else k): v for k, v in published.items()}
    assert torch.equal(voxtral_to_port(bare)["lm_head.weight"], published["language_model.lm_head.weight"])
    with pytest.raises(KeyError):
        voxtral_to_port({**published, "language_model.model.rotary_emb.inv_freq": torch.zeros(8)})


def test_init_draws_the_published_scales_and_takes_a_checkpoint(tmp_path, monkeypatch):
    monkeypatch.setattr(e2e, "VoxtralDetector", tiny_model)
    seeded = e2e.init_voxtral_detect(seed=7, device="cpu")
    ids = torch.cat([seeded.prefix_ids, seeded.suffix_ids, seeded.answer_ids])
    assert len(set(ids.tolist())) == 22 and int(ids.min()) >= 1000 and VCFG.audio_token_id not in ids.tolist()
    layer = seeded.layers[0].requires_grad_(False)
    assert 0.015 < float(layer.gate.weight.std()) < 0.025 and float(layer.attn_norm.weight.min()) == 1.0
    assert 0.015 < float(seeded.embed.weight.detach().std()) < 0.025
    assert float(seeded.whisper.layers[0].fc1.bias.detach().abs().max()) == 0
    again = e2e.init_voxtral_detect(seed=7, device="cpu")
    assert torch.equal(again.lm_head.weight, seeded.lm_head.weight) and torch.equal(again.prefix_ids, seeded.prefix_ids)
    g = torch.Generator().manual_seed(4)
    published = {k: torch.randn(s, generator=g) for k, s in _hf_names(VCFG).items()}
    torch.save(published, tmp_path / "voxtral.pt")
    model = e2e.init_voxtral_detect(checkpoint=str(tmp_path / "voxtral.pt"), seed=7, device="cpu")
    expected = voxtral_to_port(published)
    for k, v in model.state_dict().items():
        want = seeded.state_dict()[k] if k.endswith("_ids") else expected[k]  # the seeded prompt kept
        torch.testing.assert_close(v, want, rtol=0, atol=0, msg=k)
    torch.save(model.state_dict(), tmp_path / "port.pt")
    back = e2e.init_voxtral_detect(checkpoint=str(tmp_path / "port.pt"), seed=9, device="cpu")
    for k, v in back.state_dict().items():
        torch.testing.assert_close(v, model.state_dict()[k], rtol=0, atol=0, msg=k)


# a tiny decoder behind a tower of the published window (1,500 positions,
# 3,000 frames, 30 s), so the CLI pads to real 30-s windows
WINDOWED = VoxtralConfig(audio=WhisperConfig(hidden=32, heads=4, ffn=128, layers=1, positions=1500,
                                             mel=MelConfig(sr=16000, n_fft=400, hop_length=160, n_mels=128,
                                                           fmax=8000.0)),
                         hidden=64, heads=8, kv_heads=2, head_dim=16, ffn=96, layers=1, vocab=2000)


def test_score_cli_pads_to_whole_windows_and_batches_equal_counts(tmp_path, monkeypatch, capsys):
    d = tmp_path / "audio"
    d.mkdir()
    rng = np.random.default_rng(1)
    clips = {"a.flac": 31.0, "b.wav": 65.0, "c.wav": 45.5}
    for name, seconds in clips.items():
        y = np.clip(rng.standard_normal(int(seconds * 16000)) * 0.1, -0.99, 0.99)
        (write_flac if name.endswith(".flac") else write_wav)(str(d / name), y, 16000)
    monkeypatch.setattr(e2e, "VoxtralDetector", lambda: VoxtralDetector(WINDOWED))
    model = e2e.init_voxtral_detect(seed=3, device="cpu")
    monkeypatch.setattr(e2e, "init_voxtral_detect", lambda checkpoint, device: model)
    make = e2e.make_voxtral_detect_scorer
    batches = []

    def recording(m):
        score = make(m)

        def call(wav):
            batches.append(tuple(wav.shape))
            return score(wav)
        return call
    monkeypatch.setattr(e2e, "make_voxtral_detect_scorer", recording)
    assert cli_main(["score", str(d), "--model", "voxtral-detect", "--allow-random", "--device", "cpu"]) == 0
    lines = [json.loads(s) for s in capsys.readouterr().out.strip().splitlines()]
    assert [Path(x["file"]).name for x in lines] == sorted(clips)
    assert all(set(x) == {"file", "bonafide_score"} for x in lines)
    # 31 s and 45.5 s pad to 2 windows and go together; 65 s pads to 3
    assert sorted(batches) == [(1, 3 * 480000), (2, 2 * 480000)]
    for line in lines:
        y = load_audio(line["file"], sr=16000)[0]
        row = np.zeros(-(-len(y) // 480000) * 480000, np.float32)
        row[:len(y)] = y  # zero-padded, as VoxtralProcessor pads
        with torch.inference_mode():
            want = float(model(torch.from_numpy(row)[None])[0])
        assert line["bonafide_score"] == pytest.approx(want, abs=1e-4)
    assert cli_main(["score", str(d), "--model", "voxtral-detect", "--allow-random", "--device", "cpu",
                     "--sr", "8000"]) == 2
