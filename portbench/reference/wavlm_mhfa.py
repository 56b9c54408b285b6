"""Plain reference of WavLM-Large + MHFA: waveform -> WavLM's 25 hidden
states -> multi-head factorized attentive pooling -> the bona fide logit.

Written from the published descriptions (WavLM: Chen et al.,
arXiv:2110.13900, ``unilm/WavLM/modules.py`` and transformers'
``WavLMAttention``, the shape of huggingface.co/microsoft/wavlm-large
``config.json``; MHFA: Peng et al., arXiv:2210.01273,
github.com/JunyiPeng00/SLT22_MultiHead-Factorized-Attentive-Pooling), in
eval mode, in plain PyTorch, in the dtype of the waveform:

- the waveform normalised per utterance: ``(x - mean) / sqrt(var + 1e-5)``
  over its samples (biased variance);
- seven strided convolutions without bias over the samples (an explicit
  unfold and product), each with LayerNorm over the channels and exact
  GELU; LayerNorm and the projection to 1024;
- the grouped positional convolution (kernel 128, 16 groups, padding 64,
  its last frame dropped) as a sum over its 128 taps, GELU, added;
- the relative-position buckets of key ``j`` for query ``i``, ``rel = j -
  i``: half the buckets a direction, ``rel > 0`` the upper half; distances
  below 80 exact, the rest ``80 + floor(log(a / 80) / log(800 / 80) *
  80)``, at most 159; ``P[h, i, j] = E[bucket, h]``;
- 24 pre-LayerNorm layers: ``x = LN1(h)``; per head, the gate ``G = a (b
  grep_a - 1) + 2`` with ``(a, b)`` the sigmoids of ``grep_linear(x_h)``
  summed in fours; ``softmax(q k^T / sqrt(64) + G P) v`` over 16 heads;
  the GELU feed-forward; the final LayerNorm. The hidden states are each
  layer's input and the final LayerNorm of the last output: 25;
- MHFA: ``K`` and ``V`` the softmax(``weights_k``)- and
  softmax(``weights_v``)-weighted sums of the 25 states, compressed to 128,
  ``A = softmax_T(att_head(k))`` over 64 heads, ``c_h = sum_t A[t, h] v_t``,
  ``pooling_fc`` to 256 and the output layer to 2.

Departures from the published code: dropouts and the pre-training tensors
are left out (inference); the positional conv's weight norm is folded
into one weight; MHFA's two-way output layer and its pairing with WavLM are
this benchmark's (``configs/wavlm-mhfa.json`` ``assumed``).

``weights`` is the benchmark's dict of tensors under the port's parameter
names (``wavlm.*``, ``mhfa.*``). ``calibrate`` sets MHFA's ``att_head``
scale and returns the logits the output layer is then set from
(``systems/wavlm_mhfa.py``). Nothing here imports the port. MHFA is smooth
everywhere (softmax pooling, no top-k), so every answer is compared.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference.common import in_blocks
from portbench.reference.xlsr_aasist import _w, gelu, layer_norm, linear


def relative_buckets(t: int, cfg: dict, device=None) -> torch.Tensor:
    """``(T, T)`` int64: the bucket of key ``j`` for query ``i``."""
    n = cfg["rel_buckets"] // 2  # buckets a direction
    exact = n // 2
    i = torch.arange(t, device=device)
    rel = i[None, :] - i[:, None]
    a = rel.abs()
    scaled = torch.log(a.clamp(min=1).double() / exact) / math.log(cfg["rel_max_distance"] / exact) * (n - exact)
    far = torch.clamp(exact + torch.floor(scaled).long(), max=n - 1)
    return torch.where(rel > 0, n, 0) + torch.where(a < exact, a, far)


def conv(x: torch.Tensor, weights: dict, name: str, stride: int) -> torch.Tensor:
    """A Conv1d without bias over time-major ``(B, T, C_in)``, no padding:
    ``(B, T', C_out)``."""
    w = _w(weights, f"{name}.weight", x)  # (C_out, C_in, k)
    return torch.einsum("btck,ock->bto", x.unfold(1, w.shape[-1], stride), w)


def pos_conv(x: torch.Tensor, weights: dict, cfg: dict) -> torch.Tensor:
    """The grouped positional convolution over ``(B, T, D)``, padding k/2 on
    both sides and the last output frame dropped, summed tap by tap:
    ``(B, T, D)``."""
    w = _w(weights, "wavlm.pos_conv.weight", x)  # (D, D / g, k)
    k, g = cfg["pos_kernel"], cfg["pos_groups"]
    b, t, d = x.shape
    per = d // g
    xp = F.pad(x, (0, 0, k // 2, k // 2)).view(b, t + k, g, per)
    wg = w.view(g, per, per, k)  # (group, out, in, tap)
    out = sum(torch.einsum("btgc,goc->btgo", xp[:, j:j + t], wg[..., j]) for j in range(k))
    return out.reshape(b, t, d) + _w(weights, "wavlm.pos_conv.bias", x)


def attention(x: torch.Tensor, weights: dict, p: str, position: torch.Tensor, heads: int) -> torch.Tensor:
    """One layer's gated relative-position self-attention over the normed
    input ``x`` ``(B, T, D)``, before the output projection."""
    b, t, d = x.shape
    dh = d // heads
    q, k, v = (linear(x, weights, f"{p}.{m}").reshape(b, t, heads, dh).transpose(1, 2) for m in "qkv")
    xh = x.reshape(b, t, heads, dh).transpose(1, 2)  # (B, H, T, 64)
    gates = torch.sigmoid(linear(xh, weights, f"{p}.grep_linear").reshape(b, heads, t, 2, 4).sum(-1))
    grep_a = _w(weights, f"{p}.grep_a", x).reshape(1, heads, 1)
    gate = gates[..., 0] * (gates[..., 1] * grep_a - 1.0) + 2.0  # (B, H, T)
    logits = q @ k.transpose(-1, -2) / math.sqrt(dh) + gate[..., None] * position
    return (torch.softmax(logits, dim=-1) @ v).transpose(1, 2).reshape(b, t, d)


def hidden_states(wav: torch.Tensor, weights: dict, cfg: dict) -> list[torch.Tensor]:
    """``(B, n)`` -> the 25 ``(B, T, hidden)`` hidden states."""
    eps = cfg["ln_eps"]
    mean = wav.mean(-1, keepdim=True)
    x = ((wav - mean) / torch.sqrt(((wav - mean) ** 2).mean(-1, keepdim=True) + 1e-5))[:, :, None]
    for i, stride in enumerate(cfg["conv_strides"]):
        x = gelu(layer_norm(conv(x, weights, f"wavlm.conv.convs.{i}", stride), weights, f"wavlm.conv.norms.{i}",
                            eps))
    h = linear(layer_norm(x, weights, "wavlm.feature_norm", eps), weights, "wavlm.proj")
    h = h + gelu(pos_conv(h, weights, cfg))
    table = _w(weights, "wavlm.rel_attn_embed.weight", h)  # (buckets, H)
    position = table[relative_buckets(h.shape[1], cfg, h.device)].permute(2, 0, 1)  # (H, T, T)
    states = []
    for n in range(cfg["layers"]):
        p = f"wavlm.layers.{n}"
        states.append(h)
        x = layer_norm(h, weights, f"{p}.attn_norm", eps)
        h = h + linear(attention(x, weights, p, position, cfg["heads"]), weights, f"{p}.out")
        h = h + linear(gelu(linear(layer_norm(h, weights, f"{p}.ffn_norm", eps), weights, f"{p}.fc1")),
                       weights, f"{p}.fc2")
    return states + [layer_norm(h, weights, "wavlm.norm", eps)]


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


def attention_logits(kv: torch.Tensor, weights: dict) -> torch.Tensor:
    """MHFA's head logits ``(B, T, heads)`` from ``compressed``."""
    return linear(kv[..., :kv.shape[-1] // 2], weights, "mhfa.att_head")


def pooled_logits(kv: torch.Tensor, weights: dict) -> torch.Tensor:
    """``compressed`` -> the ``(B, 2)`` logits."""
    v = kv[..., kv.shape[-1] // 2:]
    att = torch.softmax(attention_logits(kv, weights), dim=1)  # over T
    pooled = (att.transpose(1, 2) @ v).flatten(1)  # (B, heads x 128)
    return linear(linear(pooled, weights, "mhfa.pooling_fc"), weights, "mhfa.out_layer")


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
