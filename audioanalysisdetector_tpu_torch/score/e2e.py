"""End-to-end mel scoring: waveform batch -> spoof scores (PyTorch).

Counterpart of the JAX package's ``score/e2e.py`` (the mel half):
log-mel (a hand-written mel kernel on CUDA) -> CNN-BiLSTM hybrid -> spoof
probability, with nothing on the host between the waveform upload and the
``(B,)`` scores.
"""

from __future__ import annotations

from typing import Callable

import torch

from audioanalysisdetector_tpu_torch.frontend.mel import MelConfig, log_mel_spectrogram
from audioanalysisdetector_tpu_torch.frontend.stft import n_frames_for
from audioanalysisdetector_tpu_torch.models.cnn_bilstm import CNNBiLSTMHybrid


def melspec_features(wav: torch.Tensor, mel_cfg: MelConfig) -> torch.Tensor:
    """(B, n) -> (B, n_mels, T) log-mel feature maps."""
    return log_mel_spectrogram(wav, mel_cfg)


def _init_params(model: torch.nn.Module, generator: torch.Generator) -> None:
    """torch's default initialisation, drawn from ``generator``: uniform in
    +-1/sqrt(fan_in) for conv and dense layers, +-1/sqrt(H) for the LSTM;
    norm layers keep weight 1, bias 0."""
    for mod in model.modules():
        if isinstance(mod, (torch.nn.Conv1d, torch.nn.Linear)):
            fan_in = mod.weight[0].numel()
            bounds = {"weight": fan_in**-0.5, "bias": fan_in**-0.5}
        elif isinstance(mod, torch.nn.LSTM):
            bounds = {n: mod.hidden_size**-0.5 for n, _ in mod.named_parameters()}
        else:
            continue
        with torch.no_grad():
            for name, b in bounds.items():
                getattr(mod, name).uniform_(-b, b, generator=generator)


def init_mel_cnn_bilstm(
    mel_cfg: MelConfig,
    n_samples: int,
    *,
    checkpoint: str | None = None,
    seed: int = 0,
    device: str | torch.device = "cuda",
) -> CNNBiLSTMHybrid:
    """The flagship mel model in eval mode on ``device`` (the card unless the
    caller names another) — the one place the
    checkpoint contract lives: parameters AND trained BatchNorm statistics
    travel together (inference needs both).

    Parameters are drawn from ``torch.Generator().manual_seed(seed)``. With
    ``checkpoint``, a state dict saved by ``torch.save`` (the port's own
    format) replaces them; when it carries no BatchNorm statistics the
    initial ones stay, as in the JAX package."""
    t_frames = n_frames_for(n_samples, mel_cfg.hop_length, mel_cfg.n_fft, mel_cfg.center)
    model = CNNBiLSTMHybrid(t_frames)
    _init_params(model, torch.Generator().manual_seed(seed))
    if checkpoint:
        state = torch.load(checkpoint, map_location="cpu", weights_only=True)
        missing, unexpected = model.load_state_dict(state, strict=False)
        bn_stats = {"bn.running_mean", "bn.running_var", "bn.num_batches_tracked"}
        if unexpected or set(missing) - bn_stats:
            raise ValueError(
                f"checkpoint {checkpoint} does not fit the model: missing "
                f"{sorted(set(missing) - bn_stats)}, unexpected {sorted(unexpected)}"
            )
    return model.to(device).eval()


def make_mel_cnn_bilstm_scorer(
    model: CNNBiLSTMHybrid,
    mel_cfg: MelConfig = MelConfig(sr=16000, n_mels=64),
) -> Callable[[torch.Tensor], torch.Tensor]:
    """``(B, n_samples) -> (B,)`` spoof scores (sigmoid head), on the
    model's device, under ``torch.inference_mode()``. The waveforms are
    scored in float32, the one type the mel kernels take.

    Parity mode is full fp32: this sets
    ``torch.backends.cuda.matmul.allow_tf32 = False`` and
    ``torch.backends.cudnn.allow_tf32 = False`` for the whole process (the
    second defaults to True and would run the Conv1d in TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model.eval()

    @torch.inference_mode()
    def score(wav: torch.Tensor) -> torch.Tensor:
        feats = melspec_features(wav.to(torch.float32), mel_cfg)
        out = model(feats)
        return out.reshape(out.shape[0])

    return score
