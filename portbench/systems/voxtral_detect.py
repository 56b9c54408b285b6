"""Voxtral-Mini-3B read as a detector as the benchmark drives it: weights
made from the seed, the scorer ``score/e2e.py::make_voxtral_detect_scorer``
builds, and its layers (``frontend``: the whole-clip log-mel in windows and
the audio tower's final states; ``model``: the projector, the prompt, the
decoder and the head).

The port is imported at once, so a checkout without Voxtral fails as the
cell's system loads, before any weights are drawn. The weights are the
benchmark's own, drawn on the device one tensor at a time and handed to the
port and to the reference alike, at the published initialisation scales
but where ``configs/voxtral-detect.json`` ``assumed`` says otherwise; the
positions' table is the sinusoids, as in the published checkpoint; the
prompt's ids are drawn by the seed here (``prompt_ids``), not by the port.
The head's two answer rows are then set by the reference, in float64, from
a few seeded clips (``calibrate``): the scores' mean 0 and their standard
deviation stated.
"""

from __future__ import annotations

import torch

from audioanalysisdetector_tpu_torch.frontend.mel import MelConfig
from audioanalysisdetector_tpu_torch.models.voxtral import VoxtralConfig, VoxtralDetector
from audioanalysisdetector_tpu_torch.models.whisper import WhisperConfig
from audioanalysisdetector_tpu_torch.score.e2e import make_voxtral_detect_scorer
from portbench.harness.audio import waves
from portbench.harness.program import Program
from portbench.yardstick import voxtral_detect as yardstick

score_ops = yardstick.score_ops


def shapes(cfg: dict) -> dict[str, tuple[int, ...]]:
    """Every weight of the port's ``VoxtralDetector`` at the configuration's
    widths (the prompt's ids aside)."""
    d, f = cfg["hidden"], cfg["ffn"]
    out: dict[str, tuple[int, ...]] = {
        "whisper.conv1.weight": (d, cfg["n_mels"], 3), "whisper.conv1.bias": (d,),
        "whisper.conv2.weight": (d, d, 3), "whisper.conv2.bias": (d,),
        "whisper.positions": (cfg["positions"], d)}
    for n in range(cfg["layers"]):
        p = f"whisper.layers.{n}"
        for name, (n_out, n_in) in {"q": (d, d), "k": (d, d), "v": (d, d), "out": (d, d), "fc1": (f, d),
                                    "fc2": (d, f)}.items():
            out[f"{p}.{name}.weight"] = (n_out, n_in)
            if name != "k":
                out[f"{p}.{name}.bias"] = (n_out,)
        for norm in ("attn_norm", "ffn_norm"):
            out.update({f"{p}.{norm}.weight": (d,), f"{p}.{norm}.bias": (d,)})
    out.update({"whisper.norm.weight": (d,), "whisper.norm.bias": (d,)})
    lm, q, kv, lf = cfg["lm_hidden"], cfg["lm_heads"] * cfg["lm_head_dim"], cfg["lm_kv_heads"] * cfg["lm_head_dim"], \
        cfg["lm_ffn"]
    out.update({"projector.linear_1.weight": (lm, f), "projector.linear_2.weight": (lm, lm),
                "embed.weight": (cfg["vocab"], lm)})
    for n in range(cfg["lm_layers"]):
        p = f"layers.{n}"
        out.update({f"{p}.attn_norm.weight": (lm,), f"{p}.q.weight": (q, lm), f"{p}.k.weight": (kv, lm),
                    f"{p}.v.weight": (kv, lm), f"{p}.o.weight": (lm, q), f"{p}.ffn_norm.weight": (lm,),
                    f"{p}.gate.weight": (lf, lm), f"{p}.up.weight": (lf, lm), f"{p}.down.weight": (lm, lf)})
    out.update({"norm.weight": (lm,), "lm_head.weight": (cfg["vocab"], lm)})
    return out


def _draw(name: str, shape: tuple[int, ...], generator: torch.Generator, device) -> torch.Tensor:
    """One tensor (``assumed`` in the config): norms' scales 1 + 0.1 u and
    shifts 0.1 u, u uniform in (-1, 1); every other weight and bias N(0,
    0.02)."""
    layer, leaf = name.rsplit(".", 1)
    if layer.rsplit(".", 1)[-1].endswith("norm"):
        u = torch.rand(shape, generator=generator, device=device).mul_(2).sub_(1)
        return u.mul_(0.1).add_(1.0) if leaf == "weight" else u.mul_(0.1)
    return torch.randn(shape, generator=generator, device=device).mul_(0.02)


def prompt_ids(cfg: dict, generator: torch.Generator, device) -> dict[str, torch.Tensor]:
    """The detector's 22 ids (``assumed`` in the config): ``prompt_prefix``
    ids before the audio, ``prompt_suffix`` after it and two answer ids
    (bona fide, then spoof), distinct, drawn from ``[1000, vocab)`` less
    ``audio_token_id``; handed to the port and the reference alike."""
    pool = torch.arange(1000, cfg["vocab"], device=device)
    pool = pool[pool != cfg["audio_token_id"]]
    sizes = {"prefix_ids": cfg["prompt_prefix"], "suffix_ids": cfg["prompt_suffix"], "answer_ids": 2}
    drawn = pool[torch.randperm(pool.numel(), generator=generator, device=device)[:sum(sizes.values())]]
    return dict(zip(sizes, drawn.split(list(sizes.values()))))


def calibrate(weights: dict, wav: torch.Tensor, cfg: dict) -> None:
    """Set the head's two answer rows in place from the reference's float64
    final states of ``wav`` (one clip at a time): their mean kept, their
    half-difference put along the direction in which the clips' states
    differ most (the top singular vector of their deviations from the mean
    state, taken orthogonal to it) and scaled so that the scores over
    ``wav`` have mean 0 and standard deviation ``logit_std``. Along a
    direction the clips barely differ in, the scaling would blow the
    rounding of the last state up with the scores: along a random one, the
    program's gap from the float64 reference spread from 1.6e-5 to 1.35e-3
    over 12 seeds on an H100."""
    from portbench.reference import voxtral_detect as ref

    with torch.no_grad():
        state = torch.cat([ref.final_state(wav[i:i + 1].double(), weights, cfg) for i in range(wav.shape[0])])
        state = state.cpu()
        head = weights["lm_head.weight"]
        ids = weights["answer_ids"]
        real, fake = head[ids].double().cpu()
        centre = state.mean(0)
        spread = state - centre
        spread = spread - (spread @ centre)[:, None] / (centre @ centre) * centre
        half = torch.linalg.svd(spread, full_matrices=False).Vh[0]
        half = half * (cfg["logit_std"] / (2 * state @ half).std())
        mean = (real + fake) / 2
        head[ids] = torch.stack([mean + half, mean - half]).to(head.device, head.dtype)


def make_weights(cfg: dict, generator: torch.Generator, device, spec: dict) -> dict[str, torch.Tensor]:
    """float32 weights on ``device`` from ``generator``, a tensor at a time;
    the positions' table from the reference's formula; the prompt's ids;
    then the answer rows calibrated (in float64, by the reference) on
    ``calibration_rows`` seeded clips of the cell's length."""
    from portbench.reference import whisper_mhfa as whisper_ref

    w = {name: _draw(name, s, generator, device) for name, s in shapes(cfg).items() if name != "whisper.positions"}
    w["whisper.positions"] = whisper_ref.sinusoids(cfg["positions"], cfg["hidden"], cfg,
                                                   torch.empty(0, device=device, dtype=torch.float64)).float()
    w.update(prompt_ids(cfg, generator, device))
    calibrate(w, waves(cfg["calibration_rows"], cfg["n_samples"], cfg["sr"], generator, device, spec), cfg)
    return w


def make_aux(cfg: dict, generator: torch.Generator, device, spec: dict) -> dict:
    return {}


def voxtral_config(cfg: dict) -> VoxtralConfig:
    """The port's ``VoxtralConfig`` at the configuration's widths."""
    mel = MelConfig(sr=cfg["sr"], n_fft=cfg["n_fft"], hop_length=cfg["hop_length"], n_mels=cfg["n_mels"],
                    fmin=cfg["fmin"], fmax=cfg["fmax"])
    audio = WhisperConfig(hidden=cfg["hidden"], heads=cfg["heads"], ffn=cfg["ffn"], layers=cfg["layers"],
                          positions=cfg["positions"], eps=cfg["ln_eps"], mel=mel)
    return VoxtralConfig(audio=audio, hidden=cfg["lm_hidden"], heads=cfg["lm_heads"], kv_heads=cfg["lm_kv_heads"],
                         head_dim=cfg["lm_head_dim"], ffn=cfg["lm_ffn"], layers=cfg["lm_layers"], vocab=cfg["vocab"],
                         rope_theta=cfg["rope_theta"], eps=cfg["rms_eps"], audio_token_id=cfg["audio_token_id"],
                         prefix=cfg["prompt_prefix"], suffix=cfg["prompt_suffix"])


def build(cfg: dict, weights: dict, aux: dict, device) -> Program:
    """The port's scorer over ``weights``: ``VoxtralDetector`` at the
    configuration's widths holding them (every tensor must fit), then
    ``make_voxtral_detect_scorer``."""
    with torch.device("meta"):
        model = VoxtralDetector(voxtral_config(cfg))
    model.load_state_dict(weights, assign=True)
    model = model.to(device).eval()
    return Program(score=make_voxtral_detect_scorer(model),
                   frontend=torch.inference_mode()(lambda wav: model.encode(model.features(wav))),
                   model=torch.inference_mode()(model.answer))
