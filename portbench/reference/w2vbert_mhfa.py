"""Plain reference of w2v-BERT 2.0 + MHFA: waveform -> Kaldi filterbank ->
the Conformer's 25 hidden states -> multi-head factorized attentive pooling
-> the bona fide logit.

Written from the published descriptions (w2v-BERT 2.0: Seamless
Communication, arXiv:2312.05187, transformers' ``Wav2Vec2BertModel`` and
``SeamlessM4TFeatureExtractor``, the shape of
huggingface.co/facebook/w2v-bert-2.0 ``config.json``; MHFA: Peng et al.,
arXiv:2210.01273), in eval mode, in plain PyTorch, in the dtype of the
waveform:

- the filterbank: the samples times 2^15; frame ``f`` is samples ``160 f
  .. 160 f + 399`` (gathered by index); its mean removed; pre-emphasis
  ``y[0] = 0.03 x[0]``, ``y[i] = x[i] - 0.97 x[i - 1]``; the Povey window
  ``(0.5 - 0.5 cos(2 pi i / 399)) ** 0.85``; the power of the 512-point DFT
  as products with explicit cos and sin bases over the 400 samples (the
  zero padding adds nothing); 80 filters written as Kaldi's
  ``get_mel_banks`` writes them (filter ``m`` rises from ``mel_lo + m
  delta`` to the next step and falls over the one after, ``delta`` the
  Kaldi-mel span from 20 to 8000 Hz over 81, the bins at ``k 16000 / 512``
  Hz taken to ``1127 ln(1 + f / 700)``); ``log(max(x, 2^-23))``; each bin
  less its mean over the frames, over ``sqrt(sum of squares / (F - 1) +
  1e-7)``; an odd last frame dropped and frame pairs side by side;
- LayerNorm(160) and the projection to 1024: hidden state 0;
- 24 Conformer layers: ``h + 0.5 FFN1(LN(h))`` with ``FFN(x) = fc2(s(fc1
  x))``, ``s(x) = x sigmoid(x)``; ``h + out(Attn(LN(h)))`` with ``Attn =
  softmax((q k^T + q . E[idx]) / 8) v`` over 16 heads, ``E[idx]`` the
  ``(T, T, 64)`` table of each query's and key's row of the layer's
  ``distance_embedding``, ``idx = j - i`` limited to [-64, 8], plus 64;
  ``h + Conv(h)`` with ``Conv`` the LayerNorm, the pointwise product to
  2048, ``a sigmoid(g)`` of its halves, the causal depthwise sum ``y_t =
  sum_k w_k x_{t - 30 + k}`` over 31 taps (zeros before the first frame),
  LayerNorm, ``s``, the pointwise product to 1024; ``h + 0.5
  FFN2(LN(h))``; the layer's final LayerNorm: hidden state ``l``;
- MHFA over the 25 states, as ``reference/wavlm_mhfa.py`` pools WavLM's.

Departures from the published code: dropouts and the pre-training
tensors are left out (inference); the published extractor pads an odd
frame count with a zero frame where this drops the last frame (at 256,000
samples the count, 1,598, is even); the published extractor rounds its
spectrum to complex64 and its features to float32, where this keeps the
waveform's dtype throughout; MHFA's two-way output layer and its pairing
with w2v-BERT are this benchmark's (``configs/w2vbert-mhfa.json``
``assumed``).

``weights`` is the benchmark's dict of tensors under the port's parameter
names (``w2vbert.*``, ``mhfa.*``; the pointwise convs as ``(out, in)``
matrices). ``calibrate`` sets MHFA's ``att_head`` scale and returns the
logits the output layer is then set from (``systems/w2vbert_mhfa.py``).
Nothing here imports the port. MHFA is smooth everywhere (softmax pooling,
no top-k), so every answer is compared.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.common import in_blocks
from portbench.reference.wavlm_mhfa import attention_logits, pooled_logits
from portbench.reference.xlsr_aasist import _w, layer_norm, linear


@lru_cache(maxsize=None)
def _fbank_operands(n: int, n_fft: int, n_mels: int, sr: int, fmin: float, fmax: float,
                    power: float) -> tuple[np.ndarray, ...]:
    """float64: the Povey window ``(n,)``, the DFT's cos and sin bases
    ``(n, n_fft // 2 + 1)`` and the Kaldi filters ``(n_fft // 2 + 1,
    n_mels)``."""
    i = np.arange(n)
    window = (0.5 - 0.5 * np.cos(2.0 * np.pi * i / (n - 1))) ** power
    ang = 2.0 * np.pi * np.outer(i, np.arange(n_fft // 2 + 1)) / n_fft
    mel = lambda f: 1127.0 * np.log(1.0 + f / 700.0)  # noqa: E731
    lo, hi = mel(fmin), mel(fmax)
    delta = (hi - lo) / (n_mels + 1)
    bins = mel(np.arange(n_fft // 2 + 1) * sr / n_fft)
    filters = np.zeros((n_fft // 2 + 1, n_mels))
    for m in range(n_mels):
        left, centre, right = lo + m * delta, lo + (m + 1) * delta, lo + (m + 2) * delta
        up = (bins - left) / (centre - left)
        down = (right - bins) / (right - centre)
        filters[:, m] = np.where((bins > left) & (bins <= centre), up,
                                 np.where((bins > centre) & (bins < right), down, 0.0))
    return window, np.cos(ang), np.sin(ang), filters


def fbank(wav: torch.Tensor, cfg: dict) -> torch.Tensor:
    """``(B, n)`` -> ``(B, T, 2 x 80)`` normalised, stacked log-mel rows."""
    n, hop = cfg["frame_length"], cfg["hop_length"]
    window, cos_b, sin_b, filters = (torch.from_numpy(a).to(wav.device, wav.dtype) for a in _fbank_operands(
        n, cfg["n_fft"], cfg["n_mels"], cfg["sr"], cfg["fmin"], cfg["fmax"], cfg["window_power"]))
    count = 1 + (wav.shape[-1] - n) // hop
    idx = torch.arange(count, device=wav.device)[:, None] * hop + torch.arange(n, device=wav.device)
    x = wav[:, idx] * cfg["sample_scale"]  # (B, F, n)
    x = x - x.mean(-1, keepdim=True)
    pre = cfg["preemphasis"]
    x = torch.cat([(1.0 - pre) * x[..., :1], x[..., 1:] - pre * x[..., :-1]], dim=-1) * window
    power = (x @ cos_b) ** 2 + (x @ sin_b) ** 2
    logmel = torch.log(torch.clamp(power @ filters, min=cfg["mel_floor"]))
    centred = logmel - logmel.mean(1, keepdim=True)
    normed = centred / torch.sqrt((centred ** 2).sum(1, keepdim=True) / (count - 1) + cfg["norm_eps"])
    rows = count // cfg["stride"]
    return normed[:, :rows * cfg["stride"]].reshape(wav.shape[0], rows, -1)


def relative_index(t: int, cfg: dict, device=None) -> torch.Tensor:
    """``(T, T)`` int64: the row of ``distance_embedding`` for query ``i``
    and key ``j``."""
    left, right = cfg["rel_left"], cfg["rel_right"]
    i = torch.arange(t, device=device)
    d = i[None, :] - i[:, None]
    return torch.where(d < -left, 0, torch.where(d > right, left + right, d + left))


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def feed_forward(x: torch.Tensor, weights: dict, p: str) -> torch.Tensor:
    return linear(swish(linear(x, weights, f"{p}.fc1")), weights, f"{p}.fc2")


def attention(x: torch.Tensor, weights: dict, p: str, cfg: dict) -> torch.Tensor:
    """One layer's relative-key self-attention over the normed input ``x``
    ``(B, T, D)``, before the output projection."""
    b, t, d = x.shape
    heads = cfg["heads"]
    dh = d // heads
    q, k, v = (linear(x, weights, f"{p}.{m}").reshape(b, t, heads, dh).transpose(1, 2) for m in "qkv")
    table = _w(weights, f"{p}.distance_embedding.weight", x)[relative_index(t, cfg, x.device)]  # (T, T, 64)
    logits = (q @ k.transpose(-1, -2) + torch.einsum("bhid,ijd->bhij", q, table)) / math.sqrt(dh)
    return (torch.softmax(logits, dim=-1) @ v).transpose(1, 2).reshape(b, t, d)


def conv_module(h: torch.Tensor, weights: dict, p: str, cfg: dict) -> torch.Tensor:
    """The convolution module over ``(B, T, D)``, time-major throughout."""
    eps = cfg["ln_eps"]
    x = layer_norm(h, weights, f"{p}.norm", eps) @ _w(weights, f"{p}.pointwise1.weight", h).T  # (B, T, 2D)
    a, g = x.chunk(2, dim=-1)
    x = a * torch.sigmoid(g)
    w = _w(weights, f"{p}.depthwise.weight", h)[:, 0]  # (D, k)
    k = w.shape[-1]
    t = x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))  # k - 1 zero frames before the first
    y = sum(xp[:, j:j + t] * w[:, j] for j in range(k))
    y = swish(layer_norm(y, weights, f"{p}.depthwise_norm", eps))
    return y @ _w(weights, f"{p}.pointwise2.weight", h).T


def hidden_states(wav: torch.Tensor, weights: dict, cfg: dict) -> list[torch.Tensor]:
    """``(B, n)`` -> the 25 ``(B, T, hidden)`` hidden states."""
    eps = cfg["ln_eps"]
    h = linear(layer_norm(fbank(wav, cfg), weights, "w2vbert.feature_norm", eps), weights, "w2vbert.proj")
    states = [h]
    for n in range(cfg["layers"]):
        p = f"w2vbert.layers.{n}"
        h = h + 0.5 * feed_forward(layer_norm(h, weights, f"{p}.ffn1_norm", eps), weights, f"{p}.ffn1")
        h = h + linear(attention(layer_norm(h, weights, f"{p}.attn_norm", eps), weights, p, cfg), weights,
                       f"{p}.out")
        h = h + conv_module(h, weights, f"{p}.conv_module", cfg)
        h = h + 0.5 * feed_forward(layer_norm(h, weights, f"{p}.ffn2_norm", eps), weights, f"{p}.ffn2")
        h = layer_norm(h, weights, f"{p}.final_norm", eps)
        states.append(h)
    return states


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


def calibrate(wav: torch.Tensor, weights: dict, cfg: dict, rows: int = 8) -> torch.Tensor:
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
             rows: int = 8) -> tuple[torch.Tensor, torch.Tensor]:
    """``(B, n)`` waveforms -> (``(B,)`` bona fide logits in ``dtype``,
    ``(B,)`` all True: every answer is compared), in blocks of ``rows``
    utterances."""
    out = in_blocks(lambda x: logits(x.to(dtype), weights, cfg)[:, 1], wav, rows)
    return out, torch.ones_like(out, dtype=torch.bool)


def scores(cfg: dict, weights: dict, wav: torch.Tensor, *, aux: dict, dtype: torch.dtype = torch.float64,
           rows: int = 8) -> torch.Tensor:
    """``(B, n)`` waveforms -> ``(B,)`` bona fide logits in ``dtype``."""
    return evaluate(cfg, weights, wav, aux=aux, dtype=dtype, rows=rows)[0]
