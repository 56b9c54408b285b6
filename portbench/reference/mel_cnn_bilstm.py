"""Plain reference of the mel-parity system: waveform -> log-mel ->
CNN-BiLSTM hybrid -> spoof score.

Written from the published description (IzaP1k/AudioAnalysisDetector:
``ASV_dl_func.py:522-538`` for the features, librosa's
``melspectrogram`` + ``power_to_db(ref=np.max)``; ``cnn_bilstm_hybrid.py:20-68``
for the model), in plain PyTorch, in the dtype of the waveform:

- log-mel: reflect-padded centred frames, periodic Hann, ``torch.fft.rfft``,
  |X|^2, the Slaney filterbank, dB per utterance with ``top_db``;
- model: Conv1d with the frames as channels over the mel axis (an explicit
  unfold and product), BatchNorm with its running statistics, ReLU, max
  pool 2, a BiLSTM written out step by step, softmax attention over the
  steps followed by the model's ``LayerNorm(1)`` over the singleton axis
  (which leaves its bias), max over the steps, dense ReLU, dense, sigmoid.

``weights`` is the benchmark's dict of tensors under the model's parameter
names. Nothing here imports the port.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.common import hann, in_blocks, lstm, mel_filterbank, power_to_db


def log_mel(wav: torch.Tensor, cfg: dict) -> torch.Tensor:
    """``(B, n)`` -> ``(B, n_mels, T)`` log-mel in ``wav``'s dtype."""
    n_fft, hop = cfg["n_fft"], cfg["hop_length"]
    x = F.pad(wav[:, None], (n_fft // 2, n_fft // 2), mode="reflect")[:, 0]
    frames = x.unfold(-1, n_fft, hop)  # (B, T, n_fft)
    win = torch.as_tensor(hann(n_fft, periodic=True), dtype=wav.dtype, device=wav.device)
    spec = torch.fft.rfft(frames * win, dim=-1)
    power = spec.real ** 2 + spec.imag ** 2
    fb = torch.as_tensor(np.array(mel_filterbank(cfg["sr"], n_fft, cfg["n_mels"])), dtype=wav.dtype,
                         device=wav.device)
    mel = (power @ fb.T).transpose(1, 2)  # (B, n_mels, T)
    return power_to_db(mel, amin=cfg["amin"], top_db=cfg["top_db"])


def _w(weights: dict, name: str, like: torch.Tensor) -> torch.Tensor:
    return weights[name].to(like.device, like.dtype)


def conv(feats: torch.Tensor, weights: dict) -> torch.Tensor:
    """The Conv1d before BatchNorm: ``(B, n_mels, T)`` -> ``(B, C, n_mels)``,
    the T frames as input channels, kernel 3, zero padding 1."""
    w = _w(weights, "conv.weight", feats)  # (C, T, k)
    k = w.shape[-1]
    x = F.pad(feats.transpose(1, 2), (k // 2, k // 2))  # (B, T, n_mels + 2)
    cols = x.unfold(-1, k, 1)  # (B, T, n_mels, k)
    out = torch.einsum("btmk,ctk->bcm", cols, w)
    return out + _w(weights, "conv.bias", feats)[None, :, None]


def model(feats: torch.Tensor, weights: dict, cfg: dict, masks: tuple | None = None,
          stats: dict | None = None) -> torch.Tensor:
    """``(B, n_mels, T)`` log-mel -> ``(B,)`` logits. With ``masks`` (the
    two dropout keep-masks, ``dropout_masks``) the model is in training
    mode: BatchNorm normalises by the batch's mean and biased variance over
    the batch and mel axes, and dropout keeps the masked values scaled by
    ``1 / (1 - rate)``; ``stats``, when given, receives BatchNorm's batch
    mean and biased variance."""
    h = conv(feats, weights)
    gamma, beta = _w(weights, "bn.weight", h), _w(weights, "bn.bias", h)
    if masks is None:
        mean, var = _w(weights, "bn.running_mean", h), _w(weights, "bn.running_var", h)
    else:
        mean = h.mean(dim=(0, 2))
        var = ((h - mean[:, None]) ** 2).mean(dim=(0, 2))
        if stats is not None:
            stats.update(mean=mean.detach(), var=var.detach())
    h = (h - mean[:, None]) / torch.sqrt(var[:, None] + cfg["bn_eps"]) * gamma[:, None] + beta[:, None]
    h = torch.relu(h)
    h = h.reshape(*h.shape[:2], -1, cfg["pool"]).amax(-1)  # max pool, stride = size
    if masks is not None:
        h = torch.where(masks[0], h / (1.0 - cfg["conv_dropout"]), 0.0)
    seq = h.transpose(1, 2)  # (B, steps, C)
    p = "bilstm.lstm."
    fwd = lstm(seq, *(_w(weights, p + f"{n}_l0", seq) for n in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")))
    bwd = lstm(seq, *(_w(weights, p + f"{n}_l0_reverse", seq) for n in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")),
               reverse=True)
    out = torch.cat([fwd, bwd], dim=-1)  # (B, steps, 2H)
    att = torch.softmax(out @ _w(weights, "attention.weight", out).T + _w(weights, "attention.bias", out), dim=1)
    # LayerNorm over the last axis, of size 1, with the variance clipped at 0
    mu = att.mean(-1, keepdim=True)
    var1 = ((att * att).mean(-1, keepdim=True) - mu * mu).clamp_min(0.0)
    att = (att - mu) * torch.rsqrt(var1 + cfg["ln_eps"]) * _w(weights, "layer_norm.weight", att) \
        + _w(weights, "layer_norm.bias", att)
    pooled = torch.amax(out * att, dim=1)
    h = torch.relu(pooled @ _w(weights, "fc1.weight", pooled).T + _w(weights, "fc1.bias", pooled))
    if masks is not None:
        h = torch.where(masks[1], h / (1.0 - cfg["dropout"]), 0.0)
    return (h @ _w(weights, "fc2.weight", h).T + _w(weights, "fc2.bias", h))[:, 0]


def dropout_masks(generator: torch.Generator, rows: int, cfg: dict, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The two keep-masks of one training forward pass, drawn from
    ``generator`` in the order the layers run: uniform float32 draws over
    the pooled feature map ``(B, C, n_mels // pool)``, then over the dense
    layer ``(B, dense)``, each kept where below ``1 - rate``."""
    shape1 = (rows, cfg["conv_channels"], cfg["n_mels"] // cfg["pool"])
    m1 = torch.rand(shape1, generator=generator, device=device) < 1.0 - cfg["conv_dropout"]
    m2 = torch.rand((rows, cfg["dense_units"]), generator=generator, device=device) < 1.0 - cfg["dropout"]
    return m1, m2


def scores(cfg: dict, weights: dict, wav: torch.Tensor, *, aux: dict, dtype: torch.dtype = torch.float64,
           rows: int = 1024) -> torch.Tensor:
    """``(B, n)`` waveforms -> ``(B,)`` spoof scores, computed in ``dtype``
    in blocks of ``rows`` utterances (``aux``: nothing here)."""
    return in_blocks(lambda x: torch.sigmoid(model(log_mel(x.to(dtype), cfg), weights, cfg)), wav, rows)


def evaluate(cfg: dict, weights: dict, wav: torch.Tensor, *, aux: dict, dtype: torch.dtype = torch.float64,
             rows: int = 1024) -> tuple[torch.Tensor, torch.Tensor]:
    """(``scores``, which utterances are compared: all of them)."""
    s = scores(cfg, weights, wav, aux=aux, dtype=dtype, rows=rows)
    return s, torch.ones_like(s, dtype=torch.bool)
