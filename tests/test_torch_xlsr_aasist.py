"""SSL-AASIST in the port (``models/wav2vec2.py``, ``models/aasist.py``,
``score/e2e.py``, ``convert.py``, ``score --model xlsr-aasist``), on the CPU.

The port is held to the benchmark's plain reference
(``portbench/reference/xlsr_aasist.py``, plain torch, importing nothing of
the port) at a tiny size (conv channels 32, hidden 64, 4 heads, FFN 128, 2
layers, positional kernel 16 in 4 groups, 1-s inputs; the back end at its
own widths) on the benchmark's seeded, calibrated weights. The JAX package
has no such model, so the reference is the only yardstick here.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from audioanalysisdetector_tpu_torch.cli.main import main as cli_main
from audioanalysisdetector_tpu_torch.convert import fold_weight_norm, ssl_aasist_to_port
from audioanalysisdetector_tpu_torch.io.audio import load_audio, write_wav
from audioanalysisdetector_tpu_torch.models.aasist import SSLAASIST
from audioanalysisdetector_tpu_torch.models.wav2vec2 import XLSRConfig
from audioanalysisdetector_tpu_torch.score import e2e
from audioanalysisdetector_tpu_torch.score.streaming import tile_pad
from audioanalysisdetector_tpu_torch.utils import span

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from portbench.harness.audio import seed_generator, waves  # noqa: E402
from portbench.harness.cells import BENCH_DIR, read_json  # noqa: E402
from portbench.reference import xlsr_aasist as ref  # noqa: E402
from portbench.systems import xlsr_aasist as system  # noqa: E402

torch.set_num_threads(2)

TINY = dict(conv_dim=32, hidden=64, heads=4, ffn=128, layers=2, pos_kernel=16, pos_groups=4, n_samples=16000,
            calibration_rows=8)
CFG = {**read_json(BENCH_DIR / "configs" / "xlsr-aasist.json"), **TINY}
XCFG = XLSRConfig(conv_dim=32, hidden=64, heads=4, ffn=128, layers=2, pos_kernel=16, pos_groups=4)
AUDIO = read_json(BENCH_DIR / "traffic" / "offline-b128.json")["audio"]
POOLS = ["pool_S", "pool_T", "pool_hS1", "pool_hT1", "pool_hS2", "pool_hT2"]
# the port in float32 against the reference in float64: rounding of fp32
# through two layers and the back end, measured at <= 1.3e-5 on the logits
FP32_TOL = 1e-4


@pytest.fixture(scope="module")
def setup():
    g = seed_generator(2**31 + 5, "cpu")
    weights = system.make_weights(CFG, g, "cpu", AUDIO)
    wav = waves(6, CFG["n_samples"], CFG["sr"], g, "cpu", AUDIO)
    with torch.device("meta"):
        model = SSLAASIST(XCFG)
    model.load_state_dict({k: v.clone() for k, v in weights.items()}, assign=True)
    return weights, wav, model.eval()


def test_tiny_port_matches_reference_in_float64(setup):
    weights, wav, model = setup
    m64 = SSLAASIST(XCFG).double().eval()
    m64.load_state_dict(weights)
    x = wav.double()
    with torch.no_grad():
        conv = m64.xlsr.conv(x)
        ref_conv = x[:, :, None]
        for i, stride in enumerate(CFG["conv_strides"]):
            ref_conv = ref.gelu(ref.layer_norm(ref.conv_frames(ref_conv, weights, f"xlsr.conv.convs.{i}", stride),
                                               weights, f"xlsr.conv.norms.{i}", CFG["ln_eps"]))
        assert conv.shape == (6, 49, 32)  # 16,000 samples: 3199, 1599, 799, 399, 199, 99, 49 frames
        torch.testing.assert_close(conv, ref_conv, rtol=0, atol=1e-10)
        feats = m64.xlsr(x)
        torch.testing.assert_close(feats, ref.xlsr(x, weights, CFG), rtol=0, atol=1e-10)
        logits, _, _ = ref.logits(x, weights, CFG)
        torch.testing.assert_close(m64(x), logits, rtol=0, atol=1e-10)


def test_tiny_port_pool_selections_and_logits_in_float32(setup):
    weights, wav, model = setup
    got = {}
    hooks = [getattr(model.aasist, n).proj.register_forward_hook(
        lambda m, i, o, n=n: got.__setitem__(n, o[..., 0])) for n in POOLS]
    want = {}
    orig = ref._Pass.pool

    def record(self, h, name, *, ordered):
        want[name.split(".")[-1]] = ref.linear(h, self.weights, f"{name}.proj")[..., 0]
        return orig(self, h, name, ordered=ordered)

    try:
        with torch.inference_mode():
            out = model(wav)
        ref._Pass.pool = record
        exact, _, _ = ref.logits(wav.double(), weights, CFG)
    finally:
        ref._Pass.pool = orig
        for h in hooks:
            h.remove()
    for n in POOLS:
        k = max(int(got[n].shape[1] * CFG["pool_ratio"]), 1)
        # the kept nodes, in rank order (the branches' max pairs them by rank)
        assert torch.equal(got[n].topk(k, dim=1).indices, want[n].topk(k, dim=1).indices), n
    assert float((out.double() - exact).abs().max()) < FP32_TOL


def test_scorer_is_the_bona_fide_logit_under_spans(setup):
    weights, wav, model = setup
    score = e2e.make_xlsr_aasist_scorer(model)
    assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = score(wav)
    assert out.shape == (6,)
    with torch.inference_mode():
        torch.testing.assert_close(out, model(wav)[:, 1])
    spans = {e.name(): (e.start_ns(), e.start_ns() + e.duration_ns())
             for e in prof.profiler.kineto_results.events() if e.is_user_annotation()}
    nest = {"xlsr.features": "score.frontend", "xlsr.encoder": "score.frontend",
            "aasist.graph": "score.model", "score.frontend": "score.call", "score.model": "score.call"}
    for inner, outer in nest.items():
        assert spans[outer][0] <= spans[inner][0] and spans[inner][1] <= spans[outer][1], inner
    assert span("after") is span("off")  # the shared no-op once no profiler records


def test_topk_rule_leaves_out_a_planted_near_tie(setup):
    weights, wav, _ = setup
    _, gap, _ = ref.logits(wav.double(), weights, CFG)
    # the margin just above one utterance's smallest deciding gap: only that
    # utterance has a near tie, and breaking it the other way moves its answer
    i = int(gap.argmin())
    margin = float(gap[i]) * (1 + 1e-9)
    planted = {**CFG, "compare": {"min_topk_gap": margin, "max_tie_jump": 0.0}}
    _, _, jump = ref.logits(wav.double(), weights, planted)
    assert float(jump[i]) > 0 and bool((jump[gap > margin] == 0).all())
    _, compared = ref.evaluate(planted, weights, wav, aux={})
    assert not compared[i] and bool(compared[gap > margin].all())
    # a near tie whose other break stays within the jump limit is compared
    _, compared = ref.evaluate({**CFG, "compare": {"min_topk_gap": margin, "max_tie_jump": float(jump[i])}},
                               weights, wav, aux={})
    assert bool(compared.all())


def test_topk_gaps_count_the_order_where_it_reaches_the_answer():
    back = ref._Pass({"p.proj.weight": torch.eye(1, dtype=torch.float64),
                      "p.proj.bias": torch.zeros(1, dtype=torch.float64)}, {"pool_ratio": 0.5})
    # six nodes: ranks 1 and 2 tie, the boundary (3rd / 4th) does not
    h = torch.tensor([[2.0, 2.0, 0.5, -0.5, -1.0, -2.0]], dtype=torch.float64)[..., None]
    back.pool(h, "p", ordered=False)
    back.pool(h, "p", ordered=True)
    assert float(back.gaps[0][0]) > 0.1 and float(back.gaps[1][0]) == 0.0
    idx = torch.tensor([[0, 1, 2, 3], [0, 1, 2, 3]])
    gap = torch.tensor([[0.0, 0.5, 0.0], [0.0, 0.0, 0.0]])
    # near ties swapped from the top; a node swapped once stays put
    assert ref._swap_near_ties(idx, gap, range(3), 0.1).tolist() == [[1, 0, 3, 2], [1, 0, 3, 2]]
    assert ref._swap_near_ties(idx, gap, range(2, 3), 0.1).tolist() == [[0, 1, 3, 2], [0, 1, 3, 2]]


def test_published_widths_on_meta():
    cfg = XLSRConfig()
    with torch.device("meta"):
        model = SSLAASIST(cfg)
    assert sum(p.numel() for p in model.xlsr.parameters()) == 315_437_568
    wav = torch.empty(2, e2e.XLSR_AASIST_SAMPLES, device="meta")
    assert e2e.XLSR_AASIST_SAMPLES == 64600 and model.xlsr.features(wav).shape == (2, 201, 1024)
    assert (cfg.hidden, cfg.heads, cfg.ffn, cfg.layers, cfg.pos_kernel, cfg.pos_groups) == (1024, 16, 4096, 24, 128, 16)
    # every tensor the benchmark states, by name and shape, and no other
    bench = read_json(BENCH_DIR / "configs" / "xlsr-aasist.json")
    stated = system.shapes(bench)
    held = {k: tuple(v.shape) for k, v in model.state_dict().items() if not k.endswith("num_batches_tracked")}
    assert held == stated


def _published_state(model: SSLAASIST, g: torch.Generator) -> tuple[dict, torch.nn.Conv1d]:
    """A synthetic ``Model.state_dict()`` in the published names for the
    tiny shape (under ``module.``, as ``nn.DataParallel`` saves it), with
    the positional conv weight-normed by torch's own parametrization and
    the pre-training tensors present; and that conv."""
    sd = {k: torch.randn(v.shape, generator=g) if v.is_floating_point() else v
          for k, v in model.state_dict().items()}
    x = XCFG
    pub = {}
    pre = "ssl_model.model."
    for i in range(len(x.conv_kernels)):
        for p in ("weight", "bias"):
            pub[f"{pre}feature_extractor.conv_layers.{i}.0.{p}"] = sd[f"xlsr.conv.convs.{i}.{p}"]
            pub[f"{pre}feature_extractor.conv_layers.{i}.2.1.{p}"] = sd[f"xlsr.conv.norms.{i}.{p}"]
    for p in ("weight", "bias"):
        pub[f"{pre}layer_norm.{p}"] = sd[f"xlsr.feature_norm.{p}"]
        pub[f"{pre}post_extract_proj.{p}"] = sd[f"xlsr.proj.{p}"]
        pub[f"{pre}encoder.layer_norm.{p}"] = sd[f"xlsr.norm.{p}"]
        for n in range(x.layers):
            for theirs, ours in (("self_attn.q_proj", "q"), ("self_attn.k_proj", "k"), ("self_attn.v_proj", "v"),
                                 ("self_attn.out_proj", "out"), ("self_attn_layer_norm", "attn_norm"),
                                 ("fc1", "fc1"), ("fc2", "fc2"), ("final_layer_norm", "ffn_norm")):
                pub[f"{pre}encoder.layers.{n}.{theirs}.{p}"] = sd[f"xlsr.layers.{n}.{ours}.{p}"]
    conv = torch.nn.Conv1d(x.hidden, x.hidden, x.pos_kernel, padding=x.pos_kernel // 2, groups=x.pos_groups)
    conv = torch.nn.utils.parametrizations.weight_norm(conv, name="weight", dim=2)
    with torch.no_grad():
        conv.parametrizations.weight.original0.uniform_(0.5, 1.5, generator=g)
        conv.parametrizations.weight.original1.normal_(generator=g)
    pub[f"{pre}encoder.pos_conv.0.weight_g"] = conv.parametrizations.weight.original0.detach().clone()
    pub[f"{pre}encoder.pos_conv.0.weight_v"] = conv.parametrizations.weight.original1.detach().clone()
    pub[f"{pre}encoder.pos_conv.0.bias"] = conv.bias.detach().clone()
    pub[f"{pre}mask_emb"] = torch.randn(x.conv_dim, generator=g)
    pub[f"{pre}quantizer.vars"] = torch.randn(1, 8, 4, generator=g)
    pub[f"{pre}project_q.weight"] = torch.randn(4, 4, generator=g)
    pub[f"{pre}final_proj.weight"] = torch.randn(4, 4, generator=g)
    for k, v in sd.items():
        if k.startswith("aasist."):
            parts = k[len("aasist."):].split(".")
            if parts[0] == "encoder":
                parts.insert(2, "0")  # a Sequential of one block there
            pub[".".join(parts)] = v
    return {f"module.{k}": v for k, v in pub.items()}, conv


def test_convert_published_names_and_weight_norm_fold():
    g = torch.Generator().manual_seed(3)
    model = SSLAASIST(XCFG).eval()
    published, conv = _published_state(model, g)
    state = ssl_aasist_to_port(published)
    model.load_state_dict(state)  # strict: every tensor placed, none left over
    torch.testing.assert_close(model.xlsr.pos_conv.weight, conv.weight, rtol=1e-6, atol=1e-7)
    x = torch.randn(2, XCFG.hidden, 40, generator=g)
    with torch.no_grad():
        torch.testing.assert_close(model.xlsr.pos_conv(x), conv(x), rtol=1e-5, atol=1e-5)
    g2, v = torch.rand(1, 1, 5, generator=g) + 0.5, torch.randn(6, 3, 5, generator=g)
    w = fold_weight_norm(g2, v)
    torch.testing.assert_close(w.pow(2).sum(dim=(0, 1)).sqrt(), g2.flatten())
    bad = dict(published)
    bad["module.ssl_model.model.encoder.layers.0.self_attn.extra.weight"] = torch.zeros(1)
    with pytest.raises(KeyError):
        ssl_aasist_to_port(bad)


def test_init_takes_a_published_checkpoint(tmp_path, monkeypatch):
    g = torch.Generator().manual_seed(4)
    published, _ = _published_state(SSLAASIST(XCFG), g)
    path = tmp_path / "LA_model.pth"
    torch.save(published, path)
    monkeypatch.setattr(e2e, "SSLAASIST", lambda: SSLAASIST(XCFG))
    model = e2e.init_xlsr_aasist(checkpoint=str(path), device="cpu")
    expected = ssl_aasist_to_port(published)
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, expected[k], rtol=0, atol=0, msg=k)
    torch.save({k: v for k, v in expected.items() if k != "aasist.out_layer.bias"}, tmp_path / "short.pt")
    with pytest.raises(RuntimeError):
        e2e.init_xlsr_aasist(checkpoint=str(tmp_path / "short.pt"), device="cpu")


def _published_pad(x: np.ndarray, max_len: int) -> np.ndarray:
    """SSL_Anti-spoofing's ``pad``, as written there."""
    x_len = x.shape[0]
    if x_len >= max_len:
        return x[:max_len]
    num_repeats = int(max_len / x_len) + 1
    return np.tile(x, (1, num_repeats))[:, :max_len][0]


@pytest.mark.parametrize("length", [1, 999, 1000, 1601, 2500])
def test_tile_pad_is_the_published_pad(length):
    x = np.random.default_rng(length).standard_normal(length).astype(np.float32)
    row = np.zeros(1600, np.float32)
    row[:min(length, 1600)] = x[:1600]
    np.testing.assert_array_equal(tile_pad(row, length), _published_pad(x, 1600))


def test_score_cli_xlsr_aasist_tiles_and_cuts(tmp_path, monkeypatch, capsys):
    d = tmp_path / "audio"
    d.mkdir()
    rng = np.random.default_rng(0)
    clips = {"long.wav": (rng.standard_normal(24000) * 0.1, 16000), "short.wav": (rng.standard_normal(5000) * 0.1, 16000),
             "low.wav": (rng.standard_normal(3000) * 0.1, 8000)}
    for name, (y, sr) in clips.items():
        write_wav(str(d / name), np.clip(y, -0.99, 0.99), sr)
    model = SSLAASIST(XCFG).eval()
    e2e._init_ssl_aasist(model, torch.Generator().manual_seed(1))
    monkeypatch.setattr(e2e, "XLSR_AASIST_SAMPLES", 16000)
    monkeypatch.setattr(e2e, "init_xlsr_aasist", lambda checkpoint, device: model)
    assert cli_main(["score", str(d), "--model", "xlsr-aasist", "--allow-random", "--device", "cpu"]) == 0
    lines = [json.loads(s) for s in capsys.readouterr().out.strip().splitlines()]
    assert [Path(x["file"]).name for x in lines] == sorted(clips) and all(set(x) == {"file", "bonafide_logit"}
                                                                          for x in lines)
    rows = np.stack([_published_pad(load_audio(str(d / name), sr=16000)[0], 16000) for name in sorted(clips)])
    with torch.inference_mode():
        want = model(torch.from_numpy(rows))[:, 1].numpy()
    np.testing.assert_allclose([x["bonafide_logit"] for x in lines], want, rtol=0, atol=1e-5)
    assert cli_main(["score", str(d), "--model", "xlsr-aasist", "--allow-random", "--device", "cpu",
                     "--sr", "8000"]) == 2
