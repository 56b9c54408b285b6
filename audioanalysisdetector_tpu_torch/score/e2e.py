"""End-to-end scoring: waveform batch -> spoof scores (PyTorch).

Counterpart of the JAX package's ``score/e2e.py``: log-mel (a hand-written
mel kernel on CUDA) -> CNN-BiLSTM hybrid -> spoof probability, and the
flagship CQCC -> GMM ⊕ BiLSTM fused scorer, with nothing on the host
between the waveform upload and the ``(B,)`` scores.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from audioanalysisdetector_tpu_torch.frontend.cqcc import CQCCConfig, cqcc, transpose_cqcc
from audioanalysisdetector_tpu_torch.frontend.mel import MelConfig, log_mel_spectrogram
from audioanalysisdetector_tpu_torch.frontend.stft import n_frames_for
from audioanalysisdetector_tpu_torch.models.cnn_bilstm import CNNBiLSTMHybrid
from audioanalysisdetector_tpu_torch.models.gmm import DiagGMM
from audioanalysisdetector_tpu_torch.score.fused import fused_scores, ieee_fp32
from audioanalysisdetector_tpu_torch.utils.profiling import span


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


def _checkpoint_state(checkpoint: str) -> dict[str, torch.Tensor]:
    """A ``.msgpack`` payload of the JAX package's ``save_checkpoint``
    (read without msgpack or flax, converted from the flax layout), or a
    ``torch.save`` state dict (the port's own format)."""
    if checkpoint.endswith(".msgpack"):
        from audioanalysisdetector_tpu_torch.convert import flax_to_torch_cnn_bilstm
        from audioanalysisdetector_tpu_torch.train.checkpoint import load_payload

        payload = load_payload(checkpoint)
        return flax_to_torch_cnn_bilstm(
            {"params": payload["params"], "batch_stats": payload.get("batch_stats")}
        )
    return torch.load(checkpoint, map_location="cpu", weights_only=True)


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
    ``checkpoint`` — a JAX ``fit()`` payload (``best_model.msgpack``) or a
    state dict saved by ``torch.save`` — its weights replace them; when it
    carries no BatchNorm statistics the initial ones stay, as in the JAX
    package."""
    t_frames = n_frames_for(n_samples, mel_cfg.hop_length, mel_cfg.n_fft, mel_cfg.center)
    model = CNNBiLSTMHybrid(t_frames)
    _init_params(model, torch.Generator().manual_seed(seed))
    if checkpoint:
        missing, unexpected = model.load_state_dict(_checkpoint_state(checkpoint), strict=False)
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
    *,
    compute_dtype: torch.dtype = torch.float32,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """``(B, n_samples) -> (B,)`` spoof scores (sigmoid head), on the
    model's device, under ``torch.inference_mode()``. The waveforms are
    cast to ``compute_dtype`` before the mel (float32, or bfloat16: K1's
    bf16 route on the card); the features reach the model in float32.

    Parity mode is full fp32: this calls ``ieee_fp32`` (TF32 off for the
    whole process)."""
    ieee_fp32()
    model.eval()

    @torch.inference_mode()
    def score(wav: torch.Tensor) -> torch.Tensor:
        with span("score.call"):
            with span("score.frontend"):
                feats = melspec_features(wav.to(compute_dtype), mel_cfg)
            with span("score.model"):
                out = model(feats.float())
                return out.reshape(out.shape[0])

    return score


def make_cqcc_fused_scorer(
    model: torch.nn.Module,
    gmm_genuine: DiagGMM,
    gmm_spoof: DiagGMM,
    cqcc_cfg: CQCCConfig = CQCCConfig(),
    *,
    scaler_mean: np.ndarray | torch.Tensor | None = None,
    scaler_std: np.ndarray | torch.Tensor | None = None,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """``(B, n_samples) -> (B,)`` fused GMM ⊕ BiLSTM scores from raw audio,
    on the device of the model and GMMs, under ``torch.inference_mode()``
    with TF32 off: CQCC -> transpose -> scale -> fuse (the reference's full
    scoring path) with no per-sample host round-trip."""
    if (scaler_mean is None) != (scaler_std is None):
        # half a scaler silently skips standardization and every
        # downstream score is quietly wrong
        raise ValueError("pass BOTH scaler_mean and scaler_std, or neither")
    ieee_fp32()
    model.eval()
    device = gmm_genuine.means.device
    scale = None
    if scaler_mean is not None:
        scale = tuple(torch.as_tensor(np.asarray(a), dtype=torch.float32).to(device)
                      for a in (scaler_mean, scaler_std))

    @torch.inference_mode()
    def score(wav: torch.Tensor) -> torch.Tensor:
        with span("score.call"):
            with span("score.frontend"):
                feats = transpose_cqcc(cqcc(wav, cqcc_cfg))  # (B, T, 19)
                if scale is not None:
                    feats = (feats - scale[0]) / scale[1]
            with span("score.model"):
                return fused_scores(model, gmm_genuine, gmm_spoof, feats)

    return score


def make_e2e_train_step_inputs(wav: torch.Tensor, cqcc_cfg: CQCCConfig) -> torch.Tensor:
    """Featurize waveforms for the flagship trainer: (B, n) -> (B, 19, T)."""
    return cqcc(wav, cqcc_cfg)
