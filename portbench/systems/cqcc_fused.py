"""The port's flagship fused system as the benchmark drives it: weights
made from the seed, the scaler fitted at set-up as the scoring recipe does,
the scorer ``score/e2e.py::make_cqcc_fused_scorer`` builds, and its layers.

The BiLSTM draws torch's default fan-in bounds. The two GMMs lie over the
standardised frames: the genuine one with means near 0 and variances near
1, the spoof one the same with its means and variances moved a little, so
the log-likelihood ratio sits near 0, where the sigmoid is steepest.
"""

from __future__ import annotations

import math

import torch

from portbench.harness.audio import waves
from portbench.harness.program import Program
from portbench.yardstick.counts import fused_score_ops

score_ops = fused_score_ops


def shapes(cfg: dict) -> dict[str, tuple[int, ...]]:
    h, d, k = cfg["lstm_hidden"], cfg["n_ceps"], cfg["gmm_components"]
    out = {}
    for layer, i in (("bilstm1", d), ("bilstm2", 2 * h)):
        for sfx in ("", "_reverse"):
            out.update({f"{layer}.lstm.weight_ih_l0{sfx}": (4 * h, i), f"{layer}.lstm.weight_hh_l0{sfx}": (4 * h, h),
                        f"{layer}.lstm.bias_ih_l0{sfx}": (4 * h,), f"{layer}.lstm.bias_hh_l0{sfx}": (4 * h,)})
    out.update({"fc.weight": (cfg["classes"], 2 * h), "fc.bias": (cfg["classes"],)})
    for g in ("gmm_genuine", "gmm_spoof"):
        out.update({f"{g}.weights": (k,), f"{g}.means": (k, d), f"{g}.variances": (k, d)})
    return out


def make_weights(cfg: dict, generator: torch.Generator, device, spec: dict) -> dict[str, torch.Tensor]:
    """float32 weights on ``device`` from ``generator``, in two draws."""
    sh = shapes(cfg)
    sizes = {n: math.prod(s) for n, s in sh.items()}
    u = torch.rand(sum(sizes.values()), generator=generator, device=device) * 2 - 1
    z = torch.randn(sum(sizes.values()), generator=generator, device=device)
    w, off = {}, 0
    for name, s in sh.items():
        n = sizes[name]
        cut_u, cut_z = u[off:off + n].reshape(s), z[off:off + n].reshape(s)
        off += n
        if name.startswith("bilstm"):
            w[name] = cut_u * cfg["lstm_hidden"] ** -0.5
        elif name.startswith("fc."):
            w[name] = cut_u * (2 * cfg["lstm_hidden"]) ** -0.5
        elif name.endswith(".weights"):
            w[name] = torch.softmax(0.5 * cut_z, dim=0)
        elif name.endswith(".means"):
            w[name] = 0.7 * cut_z
        else:
            w[name] = torch.exp(0.3 * cut_u)
    w["gmm_spoof.weights"] = w["gmm_genuine.weights"].clone()
    w["gmm_spoof.means"] = w["gmm_genuine.means"] + cfg["spoof_shift"] * w["gmm_spoof.means"]
    w["gmm_spoof.variances"] = w["gmm_genuine.variances"] * w["gmm_spoof.variances"] ** 0.3
    return {k: v.contiguous() for k, v in w.items()}


def make_aux(cfg: dict, generator: torch.Generator, device, spec: dict) -> dict:
    """The utterances the scaler is fitted on, made from the seed."""
    return {"scaler_wav": waves(cfg["scaler_rows"], cfg["n_samples"], cfg["sr"], generator, device, spec)}


def _cqcc_config(cfg: dict):
    from audioanalysisdetector_tpu_torch.frontend.cqcc import CQCCConfig
    from audioanalysisdetector_tpu_torch.frontend.cqt import CQTConfig

    return CQCCConfig(cqt=CQTConfig(sr=cfg["sr"], hop_length=cfg["hop_length"], fmin=cfg["fmin"],
                                    n_bins=cfg["n_bins"], bins_per_octave=cfg["bins_per_octave"],
                                    filter_scale=cfg["filter_scale"]), n_ceps=cfg["n_ceps"])


def build(cfg: dict, weights: dict, aux: dict, device) -> Program:
    """The port's fused scorer over ``weights``: ``BiLSTMClassifier`` and two
    ``DiagGMM`` on the device, the scaler fitted on the CQCC of
    ``aux["scaler_wav"]`` (``FrameScaler.fit_sequences``), then
    ``make_cqcc_fused_scorer``."""
    from audioanalysisdetector_tpu_torch.data.scaler import FrameScaler
    from audioanalysisdetector_tpu_torch.frontend.cqcc import cqcc, transpose_cqcc
    from audioanalysisdetector_tpu_torch.models.bilstm_classifier import BiLSTMClassifier
    from audioanalysisdetector_tpu_torch.models.gmm import DiagGMM
    from audioanalysisdetector_tpu_torch.score.e2e import make_cqcc_fused_scorer
    from audioanalysisdetector_tpu_torch.score.fused import fused_scores, ieee_fp32

    ieee_fp32()
    cq = _cqcc_config(cfg)
    model = BiLSTMClassifier(hidden=cfg["lstm_hidden"], num_classes=cfg["classes"], input_dim=cfg["n_ceps"])
    model.load_state_dict({k: v for k, v in weights.items() if not k.startswith("gmm_")})
    model = model.to(device).eval()
    gmms = [DiagGMM(*(weights[f"{g}.{k}"] for k in ("weights", "means", "variances")))
            for g in ("gmm_genuine", "gmm_spoof")]
    with torch.inference_mode():
        frames = transpose_cqcc(cqcc(aux["scaler_wav"], cq)).cpu().numpy()
    scaler = FrameScaler.fit_sequences(frames)
    score = make_cqcc_fused_scorer(model, *gmms, cq, scaler_mean=scaler.mean, scaler_std=scaler.std)
    mean, std = (torch.as_tensor(a, device=device) for a in (scaler.mean, scaler.std))
    return Program(score=score,
                   frontend=torch.inference_mode()(lambda wav: transpose_cqcc(cqcc(wav, cq))),
                   model=torch.inference_mode()(lambda feats: fused_scores(model, *gmms, (feats - mean) / std)))
