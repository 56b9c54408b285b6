"""w2v-BERT 2.0 + MHFA as the benchmark drives it: weights made from the
seed, the scorer ``score/e2e.py::make_w2vbert_mhfa_scorer`` builds, and its
layers (``frontend``: the filterbank and the Conformer's 25 hidden states;
``model``: MHFA).

The port is imported at once, so a checkout without w2v-BERT-MHFA fails as
the cell's system loads, before any weights are drawn. The weights are the
benchmark's own, drawn on the device in two calls and handed to the port
and to the reference alike, at the published initialisation scales but
where ``configs/w2vbert-mhfa.json`` ``assumed`` says otherwise. MHFA's
attention head and its output layer are then set by the reference, in
float64, from a few seeded utterances
(``reference/w2vbert_mhfa.py::calibrate``): each head's softmax over time
is peaked, and the logits spread with a stated standard deviation.
"""

from __future__ import annotations

import math

import torch

from audioanalysisdetector_tpu_torch.frontend.fbank import FbankConfig
from audioanalysisdetector_tpu_torch.models.mhfa import W2VBertMHFA
from audioanalysisdetector_tpu_torch.models.w2v_bert import W2VBertConfig
from audioanalysisdetector_tpu_torch.score.e2e import make_w2vbert_mhfa_scorer
from portbench.harness.audio import waves
from portbench.harness.program import Program
from portbench.yardstick import w2vbert_mhfa as yardstick

score_ops = yardstick.score_ops


def _linear(name: str, n_in: int, n_out: int, bias: bool = True) -> dict[str, tuple[int, ...]]:
    return {f"{name}.weight": (n_out, n_in), **({f"{name}.bias": (n_out,)} if bias else {})}


def _norm(name: str, c: int) -> dict[str, tuple[int, ...]]:
    return {f"{name}.weight": (c,), f"{name}.bias": (c,)}


def shapes(cfg: dict) -> dict[str, tuple[int, ...]]:
    """Every tensor of the port's ``W2VBertMHFA`` at the configuration's widths."""
    d, f, h = cfg["hidden"], cfg["ffn"], cfg["heads"]
    feat = cfg["n_mels"] * cfg["stride"]
    out: dict[str, tuple[int, ...]] = {}
    out.update(_norm("w2vbert.feature_norm", feat))
    out.update(_linear("w2vbert.proj", feat, d))
    for n in range(cfg["layers"]):
        p = f"w2vbert.layers.{n}"
        out.update(_norm(f"{p}.ffn1_norm", d))
        out.update(_linear(f"{p}.ffn1.fc1", d, f))
        out.update(_linear(f"{p}.ffn1.fc2", f, d))
        out.update(_norm(f"{p}.attn_norm", d))
        for m in ("q", "k", "v", "out"):
            out.update(_linear(f"{p}.{m}", d, d))
        out[f"{p}.distance_embedding.weight"] = (cfg["rel_left"] + cfg["rel_right"] + 1, d // h)
        c = f"{p}.conv_module"
        out.update(_norm(f"{c}.norm", d))
        out.update(_linear(f"{c}.pointwise1", d, 2 * d, bias=False))
        out[f"{c}.depthwise.weight"] = (d, 1, cfg["conv_kernel"])
        out.update(_norm(f"{c}.depthwise_norm", d))
        out.update(_linear(f"{c}.pointwise2", d, d, bias=False))
        out.update(_norm(f"{p}.ffn2_norm", d))
        out.update(_linear(f"{p}.ffn2.fc1", d, f))
        out.update(_linear(f"{p}.ffn2.fc2", f, d))
        out.update(_norm(f"{p}.final_norm", d))
    comp = cfg["mhfa_compression"]
    out.update({"mhfa.weights_k": (cfg["layers"] + 1,), "mhfa.weights_v": (cfg["layers"] + 1,)})
    out.update(_linear("mhfa.cmp_linear_k", d, comp))
    out.update(_linear("mhfa.cmp_linear_v", d, comp))
    out.update(_linear("mhfa.att_head", comp, cfg["mhfa_heads"]))
    out.update(_linear("mhfa.pooling_fc", cfg["mhfa_heads"] * comp, cfg["mhfa_outputs"]))
    out.update(_linear("mhfa.out_layer", cfg["mhfa_outputs"], 2))
    return out


def _draw(name: str, sh: dict, u: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """One tensor from a uniform (-1, 1) cut ``u`` and a normal cut ``z``
    (``assumed`` in the config)."""
    layer, leaf = name.rsplit(".", 1)
    if layer.rsplit(".", 1)[-1].endswith("norm"):
        return 1.0 + 0.1 * u if leaf == "weight" else 0.1 * u
    if ".pointwise" in layer or layer.endswith(".depthwise"):
        return z * (2.0 / math.prod(sh[name][1:])) ** 0.5  # Kaiming normal over the fan in
    if leaf == "weight" and layer.endswith(".distance_embedding"):
        return z
    if name.startswith("w2vbert.layers."):
        return 0.02 * z  # the linear layers' N(0, 0.02); the biases drawn at that scale too
    if name in ("mhfa.weights_k", "mhfa.weights_v"):
        return z
    return u * math.prod(sh[layer + ".weight"][1:]) ** -0.5  # the projection and MHFA: the fan-in bound


def make_weights(cfg: dict, generator: torch.Generator, device, spec: dict) -> dict[str, torch.Tensor]:
    """float32 weights on ``device`` from ``generator``: one uniform and one
    normal draw, cut to the tensors, then MHFA calibrated (in float64, by
    the reference) on ``calibration_rows`` seeded utterances."""
    from portbench.reference import w2vbert_mhfa as ref

    sh = shapes(cfg)
    total = sum(math.prod(s) for s in sh.values())
    u = torch.rand(total, generator=generator, device=device) * 2 - 1
    z = torch.randn(total, generator=generator, device=device)
    w, off = {}, 0
    for name, s in sh.items():
        n = math.prod(s)
        w[name] = _draw(name, sh, u[off:off + n].reshape(s), z[off:off + n].reshape(s)).contiguous()
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


def _w2vbert_config(cfg: dict) -> W2VBertConfig:
    """The port's ``W2VBertConfig`` at the configuration's widths."""
    fbank = FbankConfig(sr=cfg["sr"], frame_length=cfg["frame_length"], hop_length=cfg["hop_length"],
                        n_fft=cfg["n_fft"], n_mels=cfg["n_mels"], fmin=cfg["fmin"], fmax=cfg["fmax"],
                        preemphasis=cfg["preemphasis"], window_power=cfg["window_power"],
                        sample_scale=cfg["sample_scale"], mel_floor=cfg["mel_floor"], norm_eps=cfg["norm_eps"],
                        stride=cfg["stride"])
    return W2VBertConfig(hidden=cfg["hidden"], heads=cfg["heads"], ffn=cfg["ffn"], layers=cfg["layers"],
                         conv_kernel=cfg["conv_kernel"], rel_left=cfg["rel_left"], rel_right=cfg["rel_right"],
                         eps=cfg["ln_eps"], fbank=fbank)


def build(cfg: dict, weights: dict, aux: dict, device) -> Program:
    """The port's scorer over ``weights``: ``W2VBertMHFA`` at the
    configuration's widths holding them (every tensor must fit), then
    ``make_w2vbert_mhfa_scorer``."""
    with torch.device("meta"):
        model = W2VBertMHFA(_w2vbert_config(cfg), cfg["mhfa_heads"], cfg["mhfa_compression"], cfg["mhfa_outputs"])
    model.load_state_dict(weights, assign=True)
    model = model.to(device).eval()
    score = make_w2vbert_mhfa_scorer(model)
    return Program(score=score,
                   frontend=torch.inference_mode()(
                       lambda wav: model.w2vbert.hidden_states(model.w2vbert.features(wav))),
                   model=torch.inference_mode()(lambda states: model.mhfa(states)[:, 1]))
