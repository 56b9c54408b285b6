"""w2v-BERT 2.0, the Conformer speech encoder of Seamless (PyTorch).

Seamless Communication, arXiv:2312.05187; the shape of
huggingface.co/facebook/w2v-bert-2.0 ``config.json`` (transformers'
``Wav2Vec2BertModel``, whose ``Wav2Vec2BertConfig()`` defaults are that
shape), in eval mode:

1. The Kaldi log-mel filterbank (``frontend/fbank.py::kaldi_fbank``): 80
   bins a 10-ms frame, frame pairs stacked, ``(B, T, 160)``; at 256,000
   samples T = 799.
2. LayerNorm(160) and ``proj`` Linear(160 -> 1024): hidden state 0.
3. ``ConformerLayer`` x 24 over ``(B, T, 1024)``, swish = SiLU:
   ``h + 0.5 FFN1(LN(h))``; ``h + Attn(LN(h))``, 16 heads of 64 with
   Shaw's relative-key term; ``h + Conv(h)``; ``h + 0.5 FFN2(LN(h))``; the
   layer's final LayerNorm, whose output is hidden state ``l``.

The relative-key term adds ``q . E[clamp(j - i, -64, 8) + 64] / 8`` to the
scaled logit of query ``i`` and key ``j``, with ``E`` each layer's own
``Embedding(73, 64)``: 64 keys back and 8 ahead get a row of their own,
farther keys share the end rows. It depends on ``q``, so each layer builds
its ``(B, H, T, T)`` float mask as ``R = q E^T / 8`` ``(B, H, T, 73)``
gathered by the integer index ``relative_key_index`` (a function of T
alone, kept once per T and device); the ``(T, T, 64)`` embedding tensor the
published code forms is never built. The mask goes to the SSL front ends'
one attention call (``wav2vec2.attend``).

The convolution module: LayerNorm; pointwise 1024 -> 2048 (a Conv1d of
kernel 1 without bias in the published code, a bias-free Linear here:
``convert.w2vbert_to_port`` drops the kernel axis); GLU over the channels;
a causal depthwise Conv1d (kernel 31, left pad 30, no bias); LayerNorm over
the channels; swish; pointwise 1024 -> 1024.

There is no positional convolution and no encoder-final LayerNorm.
``masked_spec_embed``, the quantizer and the adapter serve pre-training or
fine-tuning heads and are not built; dropouts are identities at inference.
``W2VBert()`` holds 580,492,096 parameters.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from functools import lru_cache

import torch
import torch.nn.functional as F
from torch import nn

from audioanalysisdetector_tpu_torch.frontend.fbank import FbankConfig, kaldi_fbank
from audioanalysisdetector_tpu_torch.models.wav2vec2 import attend, split_heads
from audioanalysisdetector_tpu_torch.utils.profiling import span


@dataclass(frozen=True)
class W2VBertConfig:
    hidden: int = 1024
    heads: int = 16
    ffn: int = 4096
    layers: int = 24
    conv_kernel: int = 31
    rel_left: int = 64  # keys back with a row of their own
    rel_right: int = 8  # keys ahead with a row of their own
    eps: float = 1e-5
    fbank: FbankConfig = field(default_factory=FbankConfig)


# huggingface.co/facebook/w2v-bert-2.0 config.json
W2V_BERT_2 = W2VBertConfig()


@lru_cache(maxsize=8)
def relative_key_index(t: int, left: int, right: int, device: torch.device) -> torch.Tensor:
    """``(T, T)`` int64 row of ``E`` for query ``i`` and key ``j``:
    ``clamp(j - i, -left, right) + left``. Integer and a function of T
    alone, so kept once per (T, device): every layer shares the one tensor
    and only reads it."""
    with torch.inference_mode(False):
        rel = torch.arange(t)[None, :] - torch.arange(t)[:, None]  # key minus query
        return (rel.clamp(-left, right) + left).to(device)


class FeedForward(nn.Module):
    def __init__(self, d: int, f: int):
        super().__init__()
        self.fc1 = nn.Linear(d, f)
        self.fc2 = nn.Linear(f, d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.silu(self.fc1(x)))


class ConvModule(nn.Module):
    """The Conformer's convolution module over ``(B, T, hidden)``: its
    output at frame t reads frames t - 30 .. t alone."""

    def __init__(self, cfg: W2VBertConfig):
        super().__init__()
        d = cfg.hidden
        self.norm = nn.LayerNorm(d, eps=cfg.eps)
        self.pointwise1 = nn.Linear(d, 2 * d, bias=False)
        self.depthwise = nn.Conv1d(d, d, cfg.conv_kernel, groups=d, bias=False)
        self.depthwise_norm = nn.LayerNorm(d, eps=cfg.eps)
        self.pointwise2 = nn.Linear(d, d, bias=False)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        with span("w2vbert.conv_module"):
            x = F.glu(self.pointwise1(self.norm(h)), dim=-1).transpose(1, 2)  # (B, D, T)
            x = self.depthwise(F.pad(x, (self.depthwise.kernel_size[0] - 1, 0)))  # causal
            return self.pointwise2(F.silu(self.depthwise_norm(x.transpose(1, 2))))


class ConformerLayer(nn.Module):
    """One w2v-BERT 2.0 layer over ``(B, T, hidden)`` (module docstring)."""

    def __init__(self, cfg: W2VBertConfig):
        super().__init__()
        d = cfg.hidden
        self.cfg = cfg
        self.ffn1_norm = nn.LayerNorm(d, eps=cfg.eps)
        self.ffn1 = FeedForward(d, cfg.ffn)
        self.attn_norm = nn.LayerNorm(d, eps=cfg.eps)
        self.q = nn.Linear(d, d)
        self.k = nn.Linear(d, d)
        self.v = nn.Linear(d, d)
        self.out = nn.Linear(d, d)
        self.distance_embedding = nn.Embedding(cfg.rel_left + cfg.rel_right + 1, d // cfg.heads)
        self.conv_module = ConvModule(cfg)
        self.ffn2_norm = nn.LayerNorm(d, eps=cfg.eps)
        self.ffn2 = FeedForward(d, cfg.ffn)
        self.final_norm = nn.LayerNorm(d, eps=cfg.eps)

    def relative_key(self, q: torch.Tensor) -> torch.Tensor:
        """The float mask ``(B, H, T, T)``: ``q . E[idx] / sqrt(d)`` for
        the split queries ``q`` ``(B, H, T, d)``."""
        b, h, t, d = q.shape
        with span("w2vbert.rel_key"):
            idx = relative_key_index(t, self.cfg.rel_left, self.cfg.rel_right, q.device)
            r = (q @ self.distance_embedding.weight.T) / math.sqrt(d)  # (B, H, T, 73)
            return torch.gather(r, -1, idx.expand(b, h, t, t))

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        n = self.cfg.heads
        h = h + 0.5 * self.ffn1(self.ffn1_norm(h))
        x = self.attn_norm(h)
        q = split_heads(self.q(x), n)
        h = h + self.out(attend(q, split_heads(self.k(x), n), split_heads(self.v(x), n), self.relative_key(q)))
        h = h + self.conv_module(h)
        h = h + 0.5 * self.ffn2(self.ffn2_norm(h))
        return self.final_norm(h)


class W2VBert(nn.Module):
    """``(B, n)`` 16-kHz waveforms -> w2v-BERT 2.0's hidden states.

    ``fbank`` (the filterbank) and ``project`` (its LayerNorm and ``proj``)
    make ``features``, hidden state 0; ``hidden_states`` runs the layers
    from it. ``score/e2e.py`` puts the filterbank and the rest under spans
    of their own."""

    def __init__(self, cfg: W2VBertConfig = W2V_BERT_2):
        super().__init__()
        self.cfg = cfg
        self.feature_norm = nn.LayerNorm(cfg.fbank.feature_dim, eps=cfg.eps)
        self.proj = nn.Linear(cfg.fbank.feature_dim, cfg.hidden)
        self.layers = nn.ModuleList(ConformerLayer(cfg) for _ in range(cfg.layers))

    def fbank(self, wav: torch.Tensor) -> torch.Tensor:
        return kaldi_fbank(wav, self.cfg.fbank)

    def project(self, feats: torch.Tensor) -> torch.Tensor:
        return self.proj(self.feature_norm(feats))

    def features(self, wav: torch.Tensor) -> torch.Tensor:
        return self.project(self.fbank(wav))

    def hidden_states(self, x: torch.Tensor) -> list[torch.Tensor]:
        """The ``layers + 1`` hidden states from ``features``' output: it,
        then each layer's output (after the layer's final LayerNorm)."""
        states = [x]
        for layer in self.layers:
            states.append(layer(states[-1]))
        return states

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        return self.hidden_states(self.features(wav))[-1]
