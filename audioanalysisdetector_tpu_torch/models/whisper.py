"""Whisper large-v3's audio encoder (PyTorch).

Radford et al., arXiv:2212.04356; the shape of
huggingface.co/openai/whisper-large-v3 ``config.json`` (``d_model`` 1280,
``encoder_layers`` 32, ``encoder_attention_heads`` 20, ``encoder_ffn_dim``
5120, ``num_mel_bins`` 128, ``max_source_positions`` 1500), as
transformers' ``WhisperEncoder`` computes it in eval mode:

1. The log-mel of a 30-s window (``frontend/mel.py::whisper_log_mel``: on
   the card K1 at n_fft 400 / hop 160, 128 Slaney bands; the last of the
   3,001 frames dropped; ``log10``, clipped at the utterance's max - 8,
   ``(x + 4) / 4``): ``(B, 128, 3000)``.
2. The conv stem: Conv1d 128 -> 1280 (kernel 3, pad 1) and Conv1d 1280 ->
   1280 (kernel 3, stride 2, pad 1), each with bias and exact GELU:
   ``(B, 1500, 1280)``, time-major.
3. The fixed sinusoids (``sinusoids``), added: hidden state 0.
4. ``WhisperLayer`` x 32: XLS-R's pre-LayerNorm layer
   (``models/wav2vec2.py::EncoderLayer``, 20 heads of 64, exact GELU,
   attention over all 1,500 positions with no mask through
   ``wav2vec2.attend``) with no bias on ``k``.
5. The final LayerNorm.

``hidden_states`` gives the 33 states that
``WhisperEncoder(output_hidden_states=True)`` gives: the embedded input,
layers 1-31's outputs, and the final LayerNorm of layer 32's output;
``last_state`` gives the last of them alone (``models/voxtral.py``). The
decoder is no part of a detector and is not built; dropouts are identities
at inference. ``WhisperEncoder()`` holds 636,968,960 parameters, the
positions' table among them (transformers keeps it as an embedding, loaded
with a checkpoint like any other tensor).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import torch
import torch.nn.functional as F
from torch import nn

from audioanalysisdetector_tpu_torch.frontend.mel import MelConfig, whisper_log_mel
from audioanalysisdetector_tpu_torch.models.wav2vec2 import EncoderLayer
from audioanalysisdetector_tpu_torch.utils.profiling import span


@dataclass(frozen=True)
class WhisperConfig:
    hidden: int = 1280
    heads: int = 20
    ffn: int = 5120
    layers: int = 32
    positions: int = 1500  # max_source_positions: the frames after the stem
    eps: float = 1e-5
    mel: MelConfig = field(default_factory=lambda: MelConfig(sr=16000, n_fft=400, hop_length=160, n_mels=128,
                                                             fmax=8000.0))


# huggingface.co/openai/whisper-large-v3 config.json and its preprocessor
WHISPER_LARGE_V3 = WhisperConfig()


def sinusoids(length: int, channels: int, max_timescale: float = 10000.0) -> torch.Tensor:
    """Whisper's ``(length, channels)`` position table, float32: ``sin(t w)``
    then ``cos(t w)`` with ``w_i = exp(-i log(max_timescale) / (channels /
    2 - 1))``, computed in float64 and rounded once."""
    increment = math.log(max_timescale) / (channels // 2 - 1)
    inv = torch.exp(-increment * torch.arange(channels // 2, dtype=torch.float64))
    t = torch.arange(length, dtype=torch.float64)[:, None] * inv
    return torch.cat([t.sin(), t.cos()], dim=1).float()


class WhisperLayer(EncoderLayer):
    """Whisper's encoder layer: ``EncoderLayer`` with a bias-free ``k``."""

    k_bias = False


class WhisperEncoder(nn.Module):
    """``(B, 480000)`` 16-kHz waveforms -> Whisper's hidden states.

    ``features`` (the log-mel) and ``hidden_states`` (the stem, the
    positions, the layers) are the two halves ``score/e2e.py`` puts under
    spans."""

    def __init__(self, cfg: WhisperConfig = WHISPER_LARGE_V3):
        super().__init__()
        self.cfg = cfg
        self.conv1 = nn.Conv1d(cfg.mel.n_mels, cfg.hidden, 3, padding=1)
        self.conv2 = nn.Conv1d(cfg.hidden, cfg.hidden, 3, stride=2, padding=1)
        self.positions = nn.Parameter(sinusoids(cfg.positions, cfg.hidden), requires_grad=False)
        self.layers = nn.ModuleList(WhisperLayer(cfg) for _ in range(cfg.layers))
        self.norm = nn.LayerNorm(cfg.hidden, eps=cfg.eps)

    def features(self, wav: torch.Tensor) -> torch.Tensor:
        """``(B, n)`` -> the ``(B, n_mels, frames)`` log-mel."""
        return whisper_log_mel(wav, self.cfg.mel)

    def conv_stem(self, mel: torch.Tensor) -> torch.Tensor:
        """``(B, n_mels, frames)`` -> ``(B, frames / 2, hidden)``."""
        with span("whisper.conv_stem"):
            return F.gelu(self.conv2(F.gelu(self.conv1(mel)))).transpose(1, 2)

    def embed_positions(self, x: torch.Tensor) -> torch.Tensor:
        """The stem's output plus the sinusoids: the first layer's input.
        Whisper takes exactly ``positions`` frames after the stem, as the
        published encoder does."""
        if x.shape[1] != self.cfg.positions:
            raise ValueError(f"Whisper's encoder takes {2 * self.cfg.positions} mel frames "
                             f"({self.cfg.positions} after the stem), got {x.shape[1]} after the stem")
        return x + self.positions

    def hidden_states(self, mel: torch.Tensor) -> list[torch.Tensor]:
        """The ``layers + 1`` hidden states from ``features``' output: each
        layer's input, then the final LayerNorm of the last layer's output."""
        h = self.embed_positions(self.conv_stem(mel))
        states = []
        for layer in self.layers:
            states.append(h)
            h = layer(h)
        return states + [self.norm(h)]

    def last_state(self, mel: torch.Tensor) -> torch.Tensor:
        """The final LayerNorm of the last layer's output alone, from
        ``features``' output: ``hidden_states()[-1]`` with no other state
        kept alive (the state Voxtral's projector reads)."""
        h = self.embed_positions(self.conv_stem(mel))
        for layer in self.layers:
            h = layer(h)
        return self.norm(h)

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        return self.last_state(self.features(wav))
