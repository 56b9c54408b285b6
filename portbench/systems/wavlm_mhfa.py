"""WavLM-Large + MHFA as the benchmark drives it: weights made from the
seed, the scorer ``score/e2e.py::make_wavlm_mhfa_scorer`` builds, and its
layers (``frontend``: WavLM's 25 hidden states; ``model``: MHFA).

The port is imported at once, so a checkout without WavLM-MHFA fails as
the cell's system loads, before any weights are drawn. The weights are the
benchmark's own, drawn on the device in two calls and
handed to the port and to the reference alike, at the published
initialisation scales but where ``configs/wavlm-mhfa.json`` ``assumed``
says otherwise. MHFA's attention head and its output layer are then set by
the reference, in float64, from a few seeded utterances
(``reference/wavlm_mhfa.py::calibrate``): each head's softmax over time is
peaked, and the logits spread with a stated standard deviation.
"""

from __future__ import annotations

import math

import torch

from audioanalysisdetector_tpu_torch.models.mhfa import WavLMMHFA
from audioanalysisdetector_tpu_torch.models.wav2vec2 import WavLMConfig
from audioanalysisdetector_tpu_torch.score.e2e import make_wavlm_mhfa_scorer
from portbench.harness.audio import waves
from portbench.harness.program import Program
from portbench.yardstick import wavlm_mhfa as yardstick

score_ops = yardstick.score_ops


def _linear(name: str, n_in: int, n_out: int) -> dict[str, tuple[int, ...]]:
    return {f"{name}.weight": (n_out, n_in), f"{name}.bias": (n_out,)}


def _norm(name: str, c: int) -> dict[str, tuple[int, ...]]:
    return {f"{name}.weight": (c,), f"{name}.bias": (c,)}


def shapes(cfg: dict) -> dict[str, tuple[int, ...]]:
    """Every tensor of the port's ``WavLMMHFA`` at the configuration's widths."""
    c, d, f, h = cfg["conv_dim"], cfg["hidden"], cfg["ffn"], cfg["heads"]
    out: dict[str, tuple[int, ...]] = {}
    for i, k in enumerate(cfg["conv_kernels"]):
        out[f"wavlm.conv.convs.{i}.weight"] = (c, 1 if i == 0 else c, k)
        out.update(_norm(f"wavlm.conv.norms.{i}", c))
    out.update(_norm("wavlm.feature_norm", c))
    out.update(_linear("wavlm.proj", c, d))
    out.update({"wavlm.pos_conv.weight": (d, d // cfg["pos_groups"], cfg["pos_kernel"]),
                "wavlm.pos_conv.bias": (d,)})
    for n in range(cfg["layers"]):
        p = f"wavlm.layers.{n}"
        out.update(_norm(f"{p}.attn_norm", d))
        for m in ("q", "k", "v", "out"):
            out.update(_linear(f"{p}.{m}", d, d))
        out.update(_norm(f"{p}.ffn_norm", d))
        out.update(_linear(f"{p}.fc1", d, f))
        out.update(_linear(f"{p}.fc2", f, d))
        out.update(_linear(f"{p}.grep_linear", d // h, 8))
        out[f"{p}.grep_a"] = (1, h, 1, 1)
    out.update(_norm("wavlm.norm", d))
    out["wavlm.rel_attn_embed.weight"] = (cfg["rel_buckets"], h)
    comp = cfg["mhfa_compression"]
    out.update({"mhfa.weights_k": (cfg["layers"] + 1,), "mhfa.weights_v": (cfg["layers"] + 1,)})
    out.update(_linear("mhfa.cmp_linear_k", d, comp))
    out.update(_linear("mhfa.cmp_linear_v", d, comp))
    out.update(_linear("mhfa.att_head", comp, cfg["mhfa_heads"]))
    out.update(_linear("mhfa.pooling_fc", cfg["mhfa_heads"] * comp, cfg["mhfa_outputs"]))
    out.update(_linear("mhfa.out_layer", cfg["mhfa_outputs"], 2))
    return out


def _draw(name: str, sh: dict, u: torch.Tensor, z: torch.Tensor, cfg: dict) -> torch.Tensor:
    """One tensor from a uniform (-1, 1) cut ``u`` and a normal cut ``z``
    (``assumed`` in the config)."""
    layer, leaf = name.rsplit(".", 1)
    if "norm" in layer.rsplit(".", 1)[-1] or ".norms." in name:
        return 1.0 + 0.1 * u if leaf == "weight" else 0.1 * u
    if name.startswith("wavlm.conv.convs."):
        return z * (2.0 / math.prod(sh[name][1:])) ** 0.5  # Kaiming normal
    if name == "wavlm.pos_conv.weight":
        return z * (4.0 / (cfg["pos_kernel"] * cfg["hidden"])) ** 0.5
    if leaf == "grep_a":
        return 1.0 + 0.1 * u
    if layer.endswith(".grep_linear") and leaf == "weight":
        # four rows of 64 summed: their sum, a gate's sigmoid input, spreads
        # with a standard deviation of about 1 over unit-scale inputs
        return z / (2 * sh[name][1] ** 0.5)
    if name.startswith(("wavlm.layers.", "wavlm.pos_conv.")):
        return 0.02 * z  # init_bert_params' N(0, 0.02); the biases drawn at that scale too
    if name in ("wavlm.rel_attn_embed.weight", "mhfa.weights_k", "mhfa.weights_v"):
        return z
    return u * math.prod(sh[layer + ".weight"][1:]) ** -0.5  # torch's fan-in bound


def make_weights(cfg: dict, generator: torch.Generator, device, spec: dict) -> dict[str, torch.Tensor]:
    """float32 weights on ``device`` from ``generator``: one uniform and one
    normal draw, cut to the tensors, then MHFA calibrated (in float64, by
    the reference) on ``calibration_rows`` seeded utterances."""
    from portbench.reference import wavlm_mhfa as ref

    sh = shapes(cfg)
    total = sum(math.prod(s) for s in sh.values())
    u = torch.rand(total, generator=generator, device=device) * 2 - 1
    z = torch.randn(total, generator=generator, device=device)
    w, off = {}, 0
    for name, s in sh.items():
        n = math.prod(s)
        w[name] = _draw(name, sh, u[off:off + n].reshape(s), z[off:off + n].reshape(s), cfg).contiguous()
        off += n
    del u, z
    calib = waves(cfg["calibration_rows"], cfg["n_samples"], cfg["sr"], generator, device, spec)
    cal = {**w, **{k: v.double() for k, v in w.items() if k.startswith("mhfa.")}}
    with torch.no_grad():
        logit = ref.calibrate(calib.double(), cal, cfg)
        scale = cfg["logit_std"] / logit.std(0)
        cal["mhfa.out_layer.weight"] = cal["mhfa.out_layer.weight"] * scale[:, None]
        cal["mhfa.out_layer.bias"] = (cal["mhfa.out_layer.bias"] - logit.mean(0)) * scale
    w.update({k: v.float().contiguous() for k, v in cal.items() if k.startswith("mhfa.")})
    return w


def make_aux(cfg: dict, generator: torch.Generator, device, spec: dict) -> dict:
    return {}


def _wavlm_config(cfg: dict) -> WavLMConfig:
    """The port's ``WavLMConfig`` at the configuration's widths."""
    return WavLMConfig(conv_dim=cfg["conv_dim"], conv_kernels=tuple(cfg["conv_kernels"]),
                       conv_strides=tuple(cfg["conv_strides"]), hidden=cfg["hidden"], heads=cfg["heads"],
                       ffn=cfg["ffn"], layers=cfg["layers"], pos_kernel=cfg["pos_kernel"],
                       pos_groups=cfg["pos_groups"], eps=cfg["ln_eps"], conv_bias=cfg["conv_bias"],
                       normalize=cfg["normalize"], rel_buckets=cfg["rel_buckets"],
                       rel_max_distance=cfg["rel_max_distance"])


def build(cfg: dict, weights: dict, aux: dict, device) -> Program:
    """The port's scorer over ``weights``: ``WavLMMHFA`` at the
    configuration's widths holding them (every tensor must fit), then
    ``make_wavlm_mhfa_scorer``."""
    with torch.device("meta"):
        model = WavLMMHFA(_wavlm_config(cfg), cfg["mhfa_heads"], cfg["mhfa_compression"], cfg["mhfa_outputs"])
    model.load_state_dict(weights, assign=True)
    model = model.to(device).eval()
    score = make_wavlm_mhfa_scorer(model)
    return Program(score=score,
                   frontend=torch.inference_mode()(lambda wav: model.wavlm.hidden_states(model.wavlm.features(wav))),
                   model=torch.inference_mode()(lambda states: model.mhfa(states)[:, 1]))
