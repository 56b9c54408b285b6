"""SSL-AASIST as the benchmark drives it: weights made from the seed, the
scorer ``score/e2e.py::make_xlsr_aasist_scorer`` builds, and its layers
(``frontend``: XLS-R; ``model``: AASIST).

The weights are the benchmark's own, drawn on the device in two calls and
handed to the port and to the reference alike, at the published
initialisation scales (``configs/xlsr-aasist.json`` ``assumed``). The back
end's BatchNorm statistics, its graph pools' projections and its output
layer are then set by the reference, in float64, from a few seeded
utterances (``reference/xlsr_aasist.py::calibrate``): every BatchNorm works
in its range, the pool scores spread so that few nearly tie, and the
logits spread with a stated standard deviation.
"""

from __future__ import annotations

import math

import torch

from portbench.harness.audio import waves
from portbench.harness.program import Program
from portbench.yardstick import xlsr_aasist as yardstick

score_ops = yardstick.score_ops

_BN = ("weight", "bias", "running_mean", "running_var")


def _bn(name: str, c: int) -> dict[str, tuple[int, ...]]:
    return {f"{name}.{p}": (c,) for p in _BN}


def _linear(name: str, n_in: int, n_out: int) -> dict[str, tuple[int, ...]]:
    return {f"{name}.weight": (n_out, n_in), f"{name}.bias": (n_out,)}


def _conv(name: str, c_in: int, c_out: int, *kernel: int) -> dict[str, tuple[int, ...]]:
    return {f"{name}.weight": (c_out, c_in, *kernel), f"{name}.bias": (c_out,)}


def shapes(cfg: dict) -> dict[str, tuple[int, ...]]:
    """Every tensor of the port's ``SSLAASIST`` at the configuration's widths
    but the BatchNorms' step counters."""
    c, d, f = cfg["conv_dim"], cfg["hidden"], cfg["ffn"]
    out: dict[str, tuple[int, ...]] = {}
    for i, k in enumerate(cfg["conv_kernels"]):
        out.update(_conv(f"xlsr.conv.convs.{i}", 1 if i == 0 else c, c, k))
        out.update({f"xlsr.conv.norms.{i}.weight": (c,), f"xlsr.conv.norms.{i}.bias": (c,)})
    out.update({"xlsr.feature_norm.weight": (c,), "xlsr.feature_norm.bias": (c,)})
    out.update(_linear("xlsr.proj", c, d))
    out.update(_conv("xlsr.pos_conv", d // cfg["pos_groups"], d, cfg["pos_kernel"]))
    for n in range(cfg["layers"]):
        p = f"xlsr.layers.{n}"
        for norm in ("attn_norm", "ffn_norm"):
            out.update({f"{p}.{norm}.weight": (d,), f"{p}.{norm}.bias": (d,)})
        for m in ("q", "k", "v", "out"):
            out.update(_linear(f"{p}.{m}", d, d))
        out.update(_linear(f"{p}.fc1", d, f))
        out.update(_linear(f"{p}.fc2", f, d))
    out.update({"xlsr.norm.weight": (d,), "xlsr.norm.bias": (d,)})

    a = "aasist"
    ll = cfg["ll_dim"]
    out.update(_linear(f"{a}.LL", d, ll))
    out.update(_bn(f"{a}.first_bn", 1))
    for i, (c_in, c_out) in enumerate(cfg["filters"]):
        p = f"{a}.encoder.{i}"
        if i > 0:
            out.update(_bn(f"{p}.bn1", c_in))
        out.update(_conv(f"{p}.conv1", c_in, c_out, 2, 3))
        out.update(_bn(f"{p}.bn2", c_out))
        out.update(_conv(f"{p}.conv2", c_out, c_out, 2, 3))
        if c_in != c_out:
            out.update(_conv(f"{p}.conv_downsample", c_in, c_out, 1, 3))
    ch = cfg["filters"][-1][1]
    out.update(_bn(f"{a}.first_bn1", ch))
    out.update(_conv(f"{a}.attention.0", ch, 2 * ch, 1, 1))
    out.update(_bn(f"{a}.attention.2", 2 * ch))
    out.update(_conv(f"{a}.attention.3", 2 * ch, ch, 1, 1))
    d0, d1 = cfg["gat_dims"]
    out.update({f"{a}.pos_S": (1, ll // 3, ch), f"{a}.master1": (1, 1, d0), f"{a}.master2": (1, 1, d0)})
    for g in ("S", "T"):
        p = f"{a}.GAT_layer_{g}"
        out.update(_linear(f"{p}.att_proj", ch, d0))
        out.update({f"{p}.att_weight": (d0, 1)})
        out.update(_linear(f"{p}.proj_with_att", ch, d0))
        out.update(_linear(f"{p}.proj_without_att", ch, d0))
        out.update(_bn(f"{p}.bn", d0))
    for name, n_in in (("ST11", d0), ("ST12", d1), ("ST21", d0), ("ST22", d1)):
        p = f"{a}.HtrgGAT_layer_{name}"
        out.update(_linear(f"{p}.proj_type1", n_in, n_in))
        out.update(_linear(f"{p}.proj_type2", n_in, n_in))
        out.update(_linear(f"{p}.att_proj", n_in, d1))
        out.update(_linear(f"{p}.att_projM", n_in, d1))
        out.update({f"{p}.att_weight{w}": (d1, 1) for w in ("11", "22", "12", "M")})
        for m in ("proj_with_att", "proj_without_att", "proj_with_attM", "proj_without_attM"):
            out.update(_linear(f"{p}.{m}", n_in, d1))
        out.update(_bn(f"{p}.bn", d1))
    for pool, n_in in (("S", d0), ("T", d0), ("hS1", d1), ("hT1", d1), ("hS2", d1), ("hT2", d1)):
        out.update(_linear(f"{a}.pool_{pool}.proj", n_in, 1))
    out.update(_linear(f"{a}.out_layer", 5 * d1, 2))
    return out


def _fan_in(name: str, sh: dict) -> int:
    return math.prod(sh[name.rsplit(".", 1)[0] + ".weight"][1:])


def _is_norm(name: str) -> bool:
    """A LayerNorm's or a BatchNorm's tensor."""
    layer = name.rsplit(".", 1)[0]
    last = layer.rsplit(".", 1)[-1]
    return (".norms." in name or last.endswith("_norm") or layer in ("xlsr.norm", "aasist.attention.2")
            or last.startswith(("bn", "first_bn")))


def _draw(name: str, sh: dict, u: torch.Tensor, z: torch.Tensor, cfg: dict) -> torch.Tensor:
    """One tensor from a uniform (-1, 1) cut ``u`` and a normal cut ``z``
    at the published initialisation scale (``assumed`` in the config)."""
    leaf = name.rsplit(".", 1)[-1]
    if _is_norm(name):
        if leaf == "running_mean":
            return torch.zeros_like(u)
        if leaf == "running_var":
            return torch.ones_like(u)
        return 1.0 + 0.1 * u if leaf == "weight" else 0.1 * u
    if name.startswith("xlsr.conv.convs.") and leaf == "weight":
        return z * (2.0 / _fan_in(name, sh)) ** 0.5  # Kaiming normal
    if name == "xlsr.pos_conv.weight":
        return z * (4.0 / (cfg["pos_kernel"] * cfg["hidden"])) ** 0.5
    if name.startswith(("xlsr.layers.", "xlsr.pos_conv.")):
        return 0.02 * z  # init_bert_params' N(0, 0.02); the biases drawn at that scale too
    if name.startswith(("aasist.pos_S", "aasist.master")):
        return z
    if "att_weight" in leaf:
        return z * (2.0 / (sh[name][0] + 1)) ** 0.5  # Xavier normal
    return u * _fan_in(name, sh) ** -0.5  # torch's fan-in bound


def make_weights(cfg: dict, generator: torch.Generator, device, spec: dict) -> dict[str, torch.Tensor]:
    """float32 weights on ``device`` from ``generator``: one uniform and one
    normal draw, cut to the tensors, then the back end calibrated (in
    float64, by the reference) on ``calibration_rows`` seeded utterances."""
    from portbench.reference import xlsr_aasist as ref

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
    cal = {**w, **{k: v.double() for k, v in w.items() if k.startswith("aasist.")}}
    with torch.no_grad():
        logit = ref.calibrate(calib.double(), cal, cfg)
        scale = cfg["logit_std"] / logit.std(0)
        cal["aasist.out_layer.weight"] = cal["aasist.out_layer.weight"] * scale[:, None]
        cal["aasist.out_layer.bias"] = (cal["aasist.out_layer.bias"] - logit.mean(0)) * scale
    w.update({k: v.float().contiguous() for k, v in cal.items() if k.startswith("aasist.")})
    for name in sh:
        if name.endswith(".running_var"):
            w[name.replace("running_var", "num_batches_tracked")] = torch.zeros((), dtype=torch.int64,
                                                                               device=device)
    return w


def make_aux(cfg: dict, generator: torch.Generator, device, spec: dict) -> dict:
    return {}


def _xlsr_config(cfg: dict):
    """The port's ``XLSRConfig`` at the configuration's widths; the back
    end's widths are the port's constants, checked against the file."""
    from audioanalysisdetector_tpu_torch.models import aasist
    from audioanalysisdetector_tpu_torch.models.wav2vec2 import XLSRConfig

    held = {"filters": [list(f) for f in aasist.FILTERS], "gat_dims": list(aasist.GAT_DIMS),
            "pool_ratio": aasist.POOL_RATIO, "ll_dim": aasist.LL_DIM}
    stated = {k: cfg[k] for k in held}
    if held != stated:
        raise ValueError(f"the port's AASIST is {held}, the configuration states {stated}")
    return XLSRConfig(conv_dim=cfg["conv_dim"], conv_kernels=tuple(cfg["conv_kernels"]),
                      conv_strides=tuple(cfg["conv_strides"]), hidden=cfg["hidden"], heads=cfg["heads"],
                      ffn=cfg["ffn"], layers=cfg["layers"], pos_kernel=cfg["pos_kernel"],
                      pos_groups=cfg["pos_groups"], eps=cfg["ln_eps"])


def build(cfg: dict, weights: dict, aux: dict, device) -> Program:
    """The port's scorer over ``weights``: ``SSLAASIST`` at the
    configuration's widths holding them (every tensor must fit), then
    ``make_xlsr_aasist_scorer``."""
    from audioanalysisdetector_tpu_torch.models.aasist import SSLAASIST
    from audioanalysisdetector_tpu_torch.score.e2e import make_xlsr_aasist_scorer

    with torch.device("meta"):
        model = SSLAASIST(_xlsr_config(cfg))
    model.load_state_dict(weights, assign=True)
    model = model.to(device).eval()
    score = make_xlsr_aasist_scorer(model)
    return Program(score=score, frontend=torch.inference_mode()(lambda wav: model.xlsr(wav)),
                   model=torch.inference_mode()(lambda feats: model.aasist(feats)[:, 1]))
