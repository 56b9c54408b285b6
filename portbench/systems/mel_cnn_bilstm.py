"""The port's mel-parity system as the benchmark drives it: weights made
from the seed, the scorer ``score/e2e.py::make_mel_cnn_bilstm_scorer``
builds (K3 on the card), its layers, and the scorer ``cli serve`` builds.

The weights are the benchmark's own, drawn on the device in one call and
handed to the port and to the reference alike. BatchNorm's running
statistics and the last layer are then set from the reference's view of a
few seeded utterances, so that every layer works in its range: the LSTM
off saturation, the scores spread over (0, 1), where a wrong layer shows.
"""

from __future__ import annotations

import math

import torch

from portbench.harness.audio import waves
from portbench.harness.program import Program
from portbench.yardstick.counts import frames, mel_score_ops

score_ops = mel_score_ops


def shapes(cfg: dict) -> dict[str, tuple[int, ...]]:
    """Every parameter of ``CNNBiLSTMHybrid`` at the configuration's widths."""
    t = frames(cfg["n_samples"], cfg["hop_length"])
    c, k, h, d = cfg["conv_channels"], cfg["conv_kernel"], cfg["lstm_units"], cfg["dense_units"]
    out = {"conv.weight": (c, t, k), "conv.bias": (c,), "bn.weight": (c,), "bn.bias": (c,),
           "bn.running_mean": (c,), "bn.running_var": (c,)}
    for sfx in ("", "_reverse"):
        out.update({f"bilstm.lstm.weight_ih_l0{sfx}": (4 * h, c), f"bilstm.lstm.weight_hh_l0{sfx}": (4 * h, h),
                    f"bilstm.lstm.bias_ih_l0{sfx}": (4 * h,), f"bilstm.lstm.bias_hh_l0{sfx}": (4 * h,)})
    out.update({"attention.weight": (1, 2 * h), "attention.bias": (1,), "layer_norm.weight": (1,),
                "layer_norm.bias": (1,), "fc1.weight": (d, 2 * h), "fc1.bias": (d,),
                "fc2.weight": (1, d), "fc2.bias": (1,)})
    return out


def _bound(name: str, shape: tuple[int, ...], cfg: dict) -> tuple[float, float]:
    """(centre, half-width) of the uniform draw: torch's default fan-in
    bounds; norm scales near 1, LayerNorm's bias positive."""
    if name.startswith("bilstm"):
        return 0.0, cfg["lstm_units"] ** -0.5
    if name in ("bn.weight", "layer_norm.weight"):
        return 1.0, 0.25
    if name == "layer_norm.bias":
        return 0.6, 0.4
    if name == "bn.bias":
        return 0.0, 0.1
    if name.endswith("running_mean") or name.endswith("running_var"):
        return 0.0, 0.0  # set from data below
    fan_in = math.prod(shape[1:]) if len(shape) > 1 else None
    layer = name.rsplit(".", 1)[0]
    if fan_in is None:
        fan_in = math.prod(shapes(cfg)[f"{layer}.weight"][1:])
    return 0.0, fan_in ** -0.5


def make_weights(cfg: dict, generator: torch.Generator, device, spec: dict) -> dict[str, torch.Tensor]:
    """float32 weights on ``device`` from ``generator``: one uniform draw,
    cut to the parameters, then BatchNorm's statistics and the output
    layer fitted (in float64, by the reference) to ``calibration_rows``
    seeded utterances."""
    from portbench.reference import mel_cnn_bilstm as ref

    sh = shapes(cfg)
    flat = torch.rand(sum(math.prod(s) for s in sh.values()), generator=generator, device=device) * 2 - 1
    w, off = {}, 0
    for name, s in sh.items():
        centre, half = _bound(name, s, cfg)
        n = math.prod(s)
        w[name] = (centre + half * flat[off:off + n]).reshape(s).contiguous()
        off += n
    calib = waves(cfg["calibration_rows"], cfg["n_samples"], cfg["sr"], generator, device, spec)
    with torch.no_grad():
        w64 = {k: v.double() for k, v in w.items()}
        feats = ref.log_mel(calib.double(), cfg)
        h = ref.conv(feats, w64)
        w["bn.running_mean"] = h.mean(dim=(0, 2)).float()
        w["bn.running_var"] = h.var(dim=(0, 2)).float()
        w64 = {k: v.double() for k, v in w.items()}
        logit = ref.model(feats, w64, cfg)
        scale = cfg["logit_std"] / float(logit.std())
        w["fc2.weight"] = (w["fc2.weight"] * scale).contiguous()
        w["fc2.bias"] = ((w["fc2.bias"] - float(logit.mean())) * scale).contiguous()
    w["bn.num_batches_tracked"] = torch.zeros((), dtype=torch.int64, device=device)
    return w


def make_aux(cfg: dict, generator: torch.Generator, device, spec: dict) -> dict:
    return {}


def _mel_config(cfg: dict):
    from audioanalysisdetector_tpu_torch.frontend.mel import MelConfig

    mel = MelConfig.for_profile(cfg["mel_profile"], cfg["sr"], n_mels=cfg["n_mels"])
    stated = {k: cfg[k] for k in ("n_fft", "hop_length", "n_mels", "power", "center", "pad_mode", "window")}
    held = {k: getattr(mel, k) for k in stated}
    if held != stated:
        raise ValueError(f"the port's {cfg['mel_profile']!r} profile is {held}, the configuration states {stated}")
    return mel


def build(cfg: dict, weights: dict, aux: dict, device) -> Program:
    """The port's scorer over ``weights``: ``init_mel_cnn_bilstm`` (the
    checkpoint contract), the weights loaded, ``make_mel_cnn_bilstm_scorer``."""
    from audioanalysisdetector_tpu_torch.score.e2e import (
        init_mel_cnn_bilstm,
        make_mel_cnn_bilstm_scorer,
        melspec_features,
    )

    mel = _mel_config(cfg)
    model = init_mel_cnn_bilstm(mel, cfg["n_samples"], device=device)
    model.load_state_dict(weights)
    score = make_mel_cnn_bilstm_scorer(model, mel)
    return Program(score=score, frontend=torch.inference_mode()(lambda wav: melspec_features(wav, mel)),
                   model=torch.inference_mode()(lambda feats: model(feats)))


def serve_scorer(cfg: dict, weights: dict, directory: str, device):
    """``(scorer, n_samples)`` as ``cli serve`` builds them: the weights
    saved as a state dict in ``directory`` and read back by
    ``build_mel_scorer(checkpoint=...)``."""
    import os

    from audioanalysisdetector_tpu_torch.serve.server import build_mel_scorer

    _mel_config(cfg)
    path = os.path.join(directory, "weights.pt")
    torch.save({k: v.cpu() for k, v in weights.items()}, path)
    return build_mel_scorer(checkpoint=path, sr=cfg["sr"], seconds=cfg["n_samples"] / cfg["sr"],
                            n_mels=cfg["n_mels"], mel_profile=cfg["mel_profile"], device=device)


def train_ops(cfg: dict) -> float:
    """Operations of one training utterance: forward and backward of the
    model, three forward passes' worth; the features are made once, at
    set-up."""
    from portbench.yardstick.counts import cnn_bilstm_ops

    return 3.0 * cnn_bilstm_ops(cfg)


def trainer(cfg: dict, tr: dict, weights: dict, wav: torch.Tensor, labels: torch.Tensor, device):
    """What ``cli train`` builds, without decoding: log-mel of every
    utterance through the port's frontend (K3) under ``torch.no_grad()`` in
    chunks, the 80/20 split (the rows are in seeded order already), a
    ``CNNBiLSTMHybrid(T, logits=True)`` holding ``weights``, Adam in a
    ``TrainState``. Returns (state, (train x, y), (val x, y))."""
    from audioanalysisdetector_tpu_torch.models.cnn_bilstm import CNNBiLSTMHybrid
    from audioanalysisdetector_tpu_torch.score.e2e import melspec_features
    from audioanalysisdetector_tpu_torch.train.optimizers import make_optimizer
    from audioanalysisdetector_tpu_torch.train.state import TrainState

    mel = _mel_config(cfg)
    with torch.no_grad():
        feats = torch.cat([melspec_features(wav[i:i + 4096], mel) for i in range(0, len(wav), 4096)])
    split = int(len(wav) * (1.0 - float(tr["val_share"])))
    model = CNNBiLSTMHybrid(feats.shape[-1], logits=True)
    model.load_state_dict(weights)
    state = TrainState.create(model=model.to(device), tx=make_optimizer(tr["optimizer"], float(tr["lr"])))
    return state, (feats[:split], labels[:split]), (feats[split:], labels[split:])
