"""Whisper large-v3's encoder + MHFA as the benchmark drives it: weights made
from the seed, the scorer ``score/e2e.py::make_whisper_mhfa_scorer`` builds,
and its layers (``frontend``: the log-mel and the encoder's 33 hidden
states; ``model``: MHFA).

The port is imported at once, so a checkout without Whisper-MHFA fails as
the cell's system loads, before any weights are drawn. The weights are the
benchmark's own, drawn on the device in two calls and handed to the port
and to the reference alike, at the published initialisation scales but
where ``configs/whisper-mhfa.json`` ``assumed`` says otherwise; the
positions' table is the sinusoids, as in the published checkpoint. MHFA's
attention head and its output layer are then set by the reference, in
float64, from a few seeded utterances
(``reference/whisper_mhfa.py::calibrate``): each head's softmax over time
is peaked, and the logits spread with a stated standard deviation.
"""

from __future__ import annotations

import math

import torch

from audioanalysisdetector_tpu_torch.frontend.mel import MelConfig
from audioanalysisdetector_tpu_torch.models.mhfa import WhisperMHFA
from audioanalysisdetector_tpu_torch.models.whisper import WhisperConfig
from audioanalysisdetector_tpu_torch.score.e2e import make_whisper_mhfa_scorer
from portbench.harness.audio import waves
from portbench.harness.program import Program
from portbench.yardstick import whisper_mhfa as yardstick

score_ops = yardstick.score_ops


def _linear(name: str, n_in: int, n_out: int, bias: bool = True) -> dict[str, tuple[int, ...]]:
    return {f"{name}.weight": (n_out, n_in), **({f"{name}.bias": (n_out,)} if bias else {})}


def _norm(name: str, c: int) -> dict[str, tuple[int, ...]]:
    return {f"{name}.weight": (c,), f"{name}.bias": (c,)}


def shapes(cfg: dict) -> dict[str, tuple[int, ...]]:
    """Every tensor of the port's ``WhisperMHFA`` at the configuration's widths."""
    d, f = cfg["hidden"], cfg["ffn"]
    out: dict[str, tuple[int, ...]] = {
        "whisper.conv1.weight": (d, cfg["n_mels"], 3), "whisper.conv1.bias": (d,),
        "whisper.conv2.weight": (d, d, 3), "whisper.conv2.bias": (d,),
        "whisper.positions": (cfg["positions"], d)}
    for n in range(cfg["layers"]):
        p = f"whisper.layers.{n}"
        out.update(_norm(f"{p}.attn_norm", d))
        out.update(_linear(f"{p}.q", d, d))
        out.update(_linear(f"{p}.k", d, d, bias=False))
        out.update(_linear(f"{p}.v", d, d))
        out.update(_linear(f"{p}.out", d, d))
        out.update(_norm(f"{p}.ffn_norm", d))
        out.update(_linear(f"{p}.fc1", d, f))
        out.update(_linear(f"{p}.fc2", f, d))
    out.update(_norm("whisper.norm", d))
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
    if name.startswith("whisper."):
        return 0.02 * z  # the convs' and linear layers' N(0, 0.02); the biases drawn at that scale too
    if name in ("mhfa.weights_k", "mhfa.weights_v"):
        return z
    return u * math.prod(sh[layer + ".weight"][1:]) ** -0.5  # MHFA: the fan-in bound


def make_weights(cfg: dict, generator: torch.Generator, device, spec: dict) -> dict[str, torch.Tensor]:
    """float32 weights on ``device`` from ``generator``: one uniform and one
    normal draw, cut to the tensors, the positions' table from the
    reference's formula, then MHFA calibrated (in float64, by the
    reference) on ``calibration_rows`` seeded utterances."""
    from portbench.reference import whisper_mhfa as ref

    sh = shapes(cfg)
    drawn = {k: s for k, s in sh.items() if k != "whisper.positions"}
    total = sum(math.prod(s) for s in drawn.values())
    u = torch.rand(total, generator=generator, device=device) * 2 - 1
    z = torch.randn(total, generator=generator, device=device)
    w, off = {}, 0
    for name, s in drawn.items():
        n = math.prod(s)
        w[name] = _draw(name, sh, u[off:off + n].reshape(s), z[off:off + n].reshape(s)).contiguous()
        off += n
    del u, z
    w["whisper.positions"] = ref.sinusoids(cfg["positions"], cfg["hidden"], cfg,
                                           torch.empty(0, device=device, dtype=torch.float64)).float()
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


def _whisper_config(cfg: dict) -> WhisperConfig:
    """The port's ``WhisperConfig`` at the configuration's widths."""
    mel = MelConfig(sr=cfg["sr"], n_fft=cfg["n_fft"], hop_length=cfg["hop_length"], n_mels=cfg["n_mels"],
                    fmin=cfg["fmin"], fmax=cfg["fmax"])
    return WhisperConfig(hidden=cfg["hidden"], heads=cfg["heads"], ffn=cfg["ffn"], layers=cfg["layers"],
                         positions=cfg["positions"], eps=cfg["ln_eps"], mel=mel)


def build(cfg: dict, weights: dict, aux: dict, device) -> Program:
    """The port's scorer over ``weights``: ``WhisperMHFA`` at the
    configuration's widths holding them (every tensor must fit), then
    ``make_whisper_mhfa_scorer``."""
    with torch.device("meta"):
        model = WhisperMHFA(_whisper_config(cfg), cfg["mhfa_heads"], cfg["mhfa_compression"], cfg["mhfa_outputs"])
    model.load_state_dict(weights, assign=True)
    model = model.to(device).eval()
    score = make_whisper_mhfa_scorer(model)
    return Program(score=score,
                   frontend=torch.inference_mode()(
                       lambda wav: model.whisper.hidden_states(model.whisper.features(wav))),
                   model=torch.inference_mode()(lambda states: model.mhfa(states)[:, 1]))
