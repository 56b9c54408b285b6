"""Plain reference of Whisper large-v3's encoder + MHFA: waveform -> Whisper's
log-mel -> the encoder's 33 hidden states -> multi-head factorized attentive
pooling -> the bona fide logit.

Written from the published descriptions (Whisper: Radford et al.,
arXiv:2212.04356, transformers' ``WhisperFeatureExtractor`` and
``WhisperEncoder``, the shape of huggingface.co/openai/whisper-large-v3
``config.json``; MHFA: Peng et al., arXiv:2210.01273), in eval mode, in
plain PyTorch, in the dtype of the waveform:

- the log-mel: the waveform reflect-padded by 200 samples a side; frame
  ``f`` is samples ``160 f .. 160 f + 399`` of it (gathered by index), 3,001
  frames of 480,000 samples; the power of its 400-point DFT under the
  periodic Hann window, as products with explicit windowed cos and sin
  bases; 128 Slaney mel filters from 0 to 8 kHz, normalised to unit area
  (``common.mel_filterbank``); the last frame dropped; ``log10(max(x,
  1e-10))``, clipped from below at the utterance's max - 8; ``(x + 4) /
  4``: ``(B, 3000, 128)``, time-major;
- the stem: Conv1d 128 -> 1280, kernel 3, one zero frame a side, exact
  GELU; Conv1d 1280 -> 1280, kernel 3, stride 2, one zero frame a side,
  exact GELU: ``(B, 1500, 1280)``;
- plus the sinusoids ``[sin(t w_i), cos(t w_i)]``, ``w_i = exp(-i log(1e4)
  / 639)``, computed here in the waveform's dtype: hidden state 0;
- 32 layers: ``h + out(Attn(LN(h)))`` with ``Attn = softmax(q k^T / 8) v``
  over 20 heads of 64 and every position, ``k`` with no bias; then ``h +
  fc2(GELU(fc1(LN(h))))`` (exact GELU): hidden states 1 .. 31 are layers
  1 .. 31's outputs;
- the final LayerNorm of layer 32's output: hidden state 32;
- MHFA over the 33 states, as ``reference/wavlm_mhfa.py`` pools WavLM's.

Departures from the published model: the log-mel's max is each utterance's
own, as transformers' extractor takes it row by row (openai's package
takes one over the batch, so a clip's features there would depend on the
batch it was scored in); the published extractor rounds its spectrum to
complex64 and its features to float32, where this keeps the waveform's
dtype throughout; the decoder is left out (a detector reads the encoder);
MHFA, its two-way output layer and its pairing with Whisper stand in for a
published head (``configs/whisper-mhfa.json`` ``assumed``). The positions'
table is computed here, not read from ``weights``: the port holds it as a
tensor, as the published checkpoint does, and the benchmark hands it the
same formula's values.

``weights`` is the benchmark's dict of tensors under the port's parameter
names (``whisper.*``, ``mhfa.*``). ``calibrate`` sets MHFA's ``att_head``
scale and returns the logits the output layer is then set from
(``systems/whisper_mhfa.py``). Nothing here imports the port. MHFA is
smooth everywhere (softmax pooling, no top-k), so every answer is
compared.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.common import hann, in_blocks, mel_filterbank
from portbench.reference.wavlm_mhfa import attention_logits, pooled_logits
from portbench.reference.xlsr_aasist import _w, conv_frames, gelu, layer_norm, linear


@lru_cache(maxsize=None)
def _logmel_operands(n_fft: int, n_mels: int, sr: int) -> tuple[np.ndarray, ...]:
    """float64: the windowed DFT's cos and sin bases ``(n_fft, n_fft // 2 +
    1)`` and the filters ``(n_fft // 2 + 1, n_mels)``."""
    ang = 2.0 * np.pi * np.outer(np.arange(n_fft), np.arange(n_fft // 2 + 1)) / n_fft
    window = hann(n_fft, periodic=True)[:, None]
    return window * np.cos(ang), window * np.sin(ang), np.array(mel_filterbank(sr, n_fft, n_mels).T)


def log_mel(wav: torch.Tensor, cfg: dict) -> torch.Tensor:
    """``(B, n)`` -> ``(B, n // hop, n_mels)`` Whisper features, time-major."""
    n_fft, hop = cfg["n_fft"], cfg["hop_length"]
    cos_b, sin_b, filters = (torch.from_numpy(a).to(wav.device, wav.dtype)
                             for a in _logmel_operands(n_fft, cfg["n_mels"], cfg["sr"]))
    padded = F.pad(wav[:, None], (n_fft // 2, n_fft // 2), mode="reflect")[:, 0]
    count = 1 + wav.shape[-1] // hop
    idx = torch.arange(count, device=wav.device)[:, None] * hop + torch.arange(n_fft, device=wav.device)
    frames = padded[:, idx]  # (B, count, n_fft)
    power = (frames @ cos_b) ** 2 + (frames @ sin_b) ** 2
    log_spec = torch.log10(torch.clamp((power @ filters)[:, :-1], min=cfg["log_floor"]))
    peak = torch.amax(log_spec, dim=(-2, -1), keepdim=True)  # each utterance's own
    return (torch.maximum(log_spec, peak - cfg["dynamic_range"]) + 4.0) / 4.0


def sinusoids(length: int, channels: int, cfg: dict, like: torch.Tensor) -> torch.Tensor:
    """``(length, channels)``: sin then cos of ``t w_i``, in ``like``'s dtype."""
    half = channels // 2
    inv = torch.exp(-math.log(cfg["max_timescale"]) / (half - 1)
                    * torch.arange(half, device=like.device, dtype=like.dtype))
    t = torch.arange(length, device=like.device, dtype=like.dtype)[:, None] * inv
    return torch.cat([torch.sin(t), torch.cos(t)], dim=1)


def conv_stem(mel: torch.Tensor, weights: dict) -> torch.Tensor:
    """``(B, F, n_mels)`` -> ``(B, F / 2, hidden)``: both convs over one zero
    frame a side, each with its GELU."""
    x = gelu(conv_frames(F.pad(mel, (0, 0, 1, 1)), weights, "whisper.conv1", 1))
    return gelu(conv_frames(F.pad(x, (0, 0, 1, 1)), weights, "whisper.conv2", 2))


def attention(x: torch.Tensor, weights: dict, p: str, cfg: dict) -> torch.Tensor:
    """One layer's self-attention over the normed input ``x`` ``(B, T, D)``
    with no mask, before the output projection."""
    b, t, d = x.shape
    heads = cfg["heads"]
    dh = d // heads
    q = linear(x, weights, f"{p}.q")
    k = x @ _w(weights, f"{p}.k.weight", x).T  # no bias
    v = linear(x, weights, f"{p}.v")
    q, k, v = (y.reshape(b, t, heads, dh).transpose(1, 2) for y in (q, k, v))
    a = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(dh), dim=-1) @ v
    return a.transpose(1, 2).reshape(b, t, d)


def hidden_states(wav: torch.Tensor, weights: dict, cfg: dict) -> list[torch.Tensor]:
    """``(B, n)`` -> the 33 ``(B, T, hidden)`` hidden states."""
    eps = cfg["ln_eps"]
    h = conv_stem(log_mel(wav, cfg), weights)
    h = h + sinusoids(h.shape[1], h.shape[2], cfg, h)
    states = []
    for n in range(cfg["layers"]):
        p = f"whisper.layers.{n}"
        states.append(h)
        h = h + linear(attention(layer_norm(h, weights, f"{p}.attn_norm", eps), weights, p, cfg), weights,
                       f"{p}.out")
        x = layer_norm(h, weights, f"{p}.ffn_norm", eps)
        h = h + linear(gelu(linear(x, weights, f"{p}.fc1")), weights, f"{p}.fc2")
    return states + [layer_norm(h, weights, "whisper.norm", eps)]


def compressed(wav: torch.Tensor, weights: dict, cfg: dict) -> torch.Tensor:
    """``(B, n)`` -> ``(B, T, 2 x 128)``: MHFA's compressed keys, then its
    compressed values."""
    states = hidden_states(wav, weights, cfg)
    out = []
    for kind in ("k", "v"):
        mix = torch.softmax(_w(weights, f"mhfa.weights_{kind}", wav), dim=0)
        summed = sum(mix[i] * s for i, s in enumerate(states))
        out.append(linear(summed, weights, f"mhfa.cmp_linear_{kind}"))
    return torch.cat(out, dim=-1)


def logits(wav: torch.Tensor, weights: dict, cfg: dict) -> torch.Tensor:
    """``(B, n)`` -> ``(B, 2)`` logits."""
    return pooled_logits(compressed(wav, weights, cfg), weights)


def calibrate(wav: torch.Tensor, weights: dict, cfg: dict, rows: int = 4) -> torch.Tensor:
    """Scale each head of ``mhfa.att_head`` so that its logits spread by
    ``cfg["att_logit_std"]`` over time within an utterance (on average over
    ``wav``): each head's softmax is then peaked. The weights are updated in
    place. Returns the ``(B, 2)`` logits, which ``logits`` gives again on
    ``wav``."""
    kv = in_blocks(lambda x: compressed(x, weights, cfg), wav, rows)
    spread = attention_logits(kv, weights).std(dim=1).mean(0)  # (heads,)
    name = "mhfa.att_head.weight"
    weights[name] = weights[name] * (cfg["att_logit_std"] / spread.to(weights[name].dtype))[:, None]
    return pooled_logits(kv, weights)


def evaluate(cfg: dict, weights: dict, wav: torch.Tensor, *, aux: dict, dtype: torch.dtype = torch.float64,
             rows: int = 4) -> tuple[torch.Tensor, torch.Tensor]:
    """``(B, n)`` waveforms -> (``(B,)`` bona fide logits in ``dtype``,
    ``(B,)`` all True: every answer is compared), in blocks of ``rows``
    utterances."""
    out = in_blocks(lambda x: logits(x.to(dtype), weights, cfg)[:, 1], wav, rows)
    return out, torch.ones_like(out, dtype=torch.bool)


def scores(cfg: dict, weights: dict, wav: torch.Tensor, *, aux: dict, dtype: torch.dtype = torch.float64,
           rows: int = 4) -> torch.Tensor:
    """``(B, n)`` waveforms -> ``(B,)`` bona fide logits in ``dtype``."""
    return evaluate(cfg, weights, wav, aux=aux, dtype=dtype, rows=rows)[0]
