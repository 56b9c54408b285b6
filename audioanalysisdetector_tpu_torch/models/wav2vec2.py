"""wav2vec 2.0 XLS-R front end, stable-layer-norm variant (PyTorch).

The self-supervised encoder that SSL-AASIST (Tak et al., Odyssey 2022,
arXiv:2202.12233; github.com/TakHemlata/SSL_Anti-spoofing ``model.py``)
fine-tunes: fairseq's ``Wav2Vec2Model`` as ``xlsr2_300m.pt`` configures it
(``extractor_mode="layer_norm"``, ``layer_norm_first=True``,
``conv_bias=True``; the shape of huggingface.co/facebook/wav2vec2-xls-r-300m
``config.json``, Babu et al., arXiv:2111.09296), run with
``features_only=True, mask=False`` as the published ``extract_feat`` does:

1. ``ConvFeatureEncoder``: seven ``Conv1d`` with bias over the raw
   waveform (no per-utterance normalisation: the published recipe feeds the
   samples as read), each followed by LayerNorm over the channels and exact
   GELU. At 64,600 samples the frames go 12,919 -> 6,459 -> 3,229 -> 1,614
   -> 806 -> 403 -> 201.
2. LayerNorm(512) and ``proj`` Linear(512 -> 1024).
3. The positional convolution: grouped ``Conv1d(k=128, padding=64,
   groups=16)`` with bias, its last output frame dropped (fairseq's
   ``SamePad`` for an even kernel), GELU, added to its input. The published
   weight norm (``weight_g`` over dim 2, ``weight_v``) is folded into one
   weight when a checkpoint is converted (``convert.fold_weight_norm``):
   the fold is exact, so the forward pass computes the plain conv.
4. ``EncoderLayer`` x 24, pre-LayerNorm: ``h + out(Attn(LN1(h)))`` with
   16 heads of 64 and no mask (every frame is real), then
   ``h + fc2(GELU(fc1(LN2(h))))``.
5. The final LayerNorm.

fairseq's ``mask_emb``, quantizer, ``project_q`` and ``final_proj`` serve
pre-training only and are not built. Dropouts are identities at inference
and are not built either. ``XLSRConfig()`` is the published shape;
``XLSR()`` holds 315,437,568 parameters.

``WavLM`` (Chen et al., IEEE JSTSP 2022, arXiv:2110.13900; the shape of
huggingface.co/microsoft/wavlm-large ``config.json``: ``WavLMConfig()``,
``WAVLM_LARGE``) is the same stack with three departures: no conv bias; the
waveform normalised per utterance first (``F.layer_norm`` over its samples, the published
``normalize``); and in every layer a gated relative-position bias added to
the scaled attention logits. The bias: ``P[h, i, j] = E[bucket(j - i), h]``
from one ``Embedding(320, 16)`` shared by the layers (``relative_buckets``:
80 exact distances a direction, then 80 logarithmic ones up to 800), and a
per-layer, per-query gate ``G = a (b grep_a - 1) + 2`` with ``a, b`` the
sigmoids of ``grep_linear`` over each head's 64 inputs summed in fours
(``GatedEncoderLayer``). ``WavLM()`` holds 315,451,968 parameters.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache

import torch
import torch.nn.functional as F
from torch import nn

from audioanalysisdetector_tpu_torch.utils.profiling import span


@dataclass(frozen=True)
class XLSRConfig:
    conv_dim: int = 512
    conv_kernels: tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_strides: tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    hidden: int = 1024
    heads: int = 16
    ffn: int = 4096
    layers: int = 24
    pos_kernel: int = 128
    pos_groups: int = 16
    eps: float = 1e-5
    conv_bias: bool = True
    normalize: bool = False  # the waveform normalised per utterance first


@dataclass(frozen=True)
class WavLMConfig(XLSRConfig):
    """WavLM's shape: XLS-R's, no conv bias, the waveform normalised, and
    its relative-position buckets."""

    conv_bias: bool = False
    normalize: bool = True
    rel_buckets: int = 320
    rel_max_distance: int = 800


# huggingface.co/microsoft/wavlm-large config.json: XLS-R's widths
WAVLM_LARGE = WavLMConfig()


class ConvFeatureEncoder(nn.Module):
    """``(B, n)`` waveforms -> ``(B, T, conv_dim)`` frames, time-major."""

    def __init__(self, cfg: XLSRConfig):
        super().__init__()
        dims = [1] + [cfg.conv_dim] * len(cfg.conv_kernels)
        self.convs = nn.ModuleList(
            nn.Conv1d(dims[i], dims[i + 1], k, stride=s, bias=cfg.conv_bias)
            for i, (k, s) in enumerate(zip(cfg.conv_kernels, cfg.conv_strides))
        )
        self.norms = nn.ModuleList(nn.LayerNorm(cfg.conv_dim, eps=cfg.eps) for _ in cfg.conv_kernels)

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        x = wav[:, None]
        for conv, norm in zip(self.convs, self.norms):
            # LayerNorm over channels: channels last for the norm and GELU,
            # back to (B, C, L) for the next conv
            h = F.gelu(norm(conv(x).transpose(1, 2)))
            x = h.transpose(1, 2)
        return h


def split_heads(y: torch.Tensor, heads: int) -> torch.Tensor:
    """``(B, T, D)`` -> ``(B, heads, T, D / heads)``, a view."""
    b, t, d = y.shape
    return y.view(b, t, heads, d // heads).transpose(1, 2)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    """The one attention call of the SSL front ends: ``softmax(q k^T /
    sqrt(d) + mask) v`` over ``(B, H, T, d)`` heads (``mask`` a float
    ``(B, H, T, T)`` added to the scaled logits, or None), merged back to
    ``(B, T, H d)``, under the ``ssl.attend`` span. ``q`` is scaled by
    ``d ** -0.5`` as fairseq scales it."""
    b, h, t, d = q.shape
    with span("ssl.attend"):
        a = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
        return a.transpose(1, 2).reshape(b, t, h * d)


class EncoderLayer(nn.Module):
    """One pre-LayerNorm transformer layer over ``(B, T, hidden)``."""

    def __init__(self, cfg: XLSRConfig):
        super().__init__()
        d = cfg.hidden
        self.heads = cfg.heads
        self.attn_norm = nn.LayerNorm(d, eps=cfg.eps)
        self.q = nn.Linear(d, d)
        self.k = nn.Linear(d, d)
        self.v = nn.Linear(d, d)
        self.out = nn.Linear(d, d)
        self.ffn_norm = nn.LayerNorm(d, eps=cfg.eps)
        self.fc1 = nn.Linear(d, cfg.ffn)
        self.fc2 = nn.Linear(cfg.ffn, d)

    def attention_bias(self, x: torch.Tensor, bias: torch.Tensor | None) -> torch.Tensor | None:
        """The float mask added to the scaled logits, from the normed input
        ``x``: ``bias`` as given (None, no mask, for XLS-R)."""
        return bias

    def forward(self, h: torch.Tensor, bias: torch.Tensor | None = None) -> torch.Tensor:
        x = self.attn_norm(h)
        mask = self.attention_bias(x, bias)
        n = self.heads
        h = h + self.out(attend(split_heads(self.q(x), n), split_heads(self.k(x), n), split_heads(self.v(x), n), mask))
        return h + self.fc2(F.gelu(self.fc1(self.ffn_norm(h))))


class GatedEncoderLayer(EncoderLayer):
    """WavLM's layer: ``EncoderLayer`` whose mask is the position bias
    ``P`` ``(H, T, T)`` gated per head and query by the layer's input."""

    def __init__(self, cfg: XLSRConfig):
        super().__init__(cfg)
        self.grep_linear = nn.Linear(cfg.hidden // cfg.heads, 8)
        self.grep_a = nn.Parameter(torch.ones(1, cfg.heads, 1, 1))

    def attention_bias(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        """``G[b, h, i] P[h, i, j]``, ``(B, H, T, T)``."""
        b, t, d = x.shape
        with span("wavlm.gated_bias"):
            g = self.grep_linear(x.view(b, t, self.heads, d // self.heads))  # (B, T, H, 8)
            g = torch.sigmoid(g.view(b, t, self.heads, 2, 4).sum(-1)).transpose(1, 2)  # (B, H, T, 2)
            gate = g[..., :1] * (g[..., 1:] * self.grep_a - 1.0) + 2.0
            return gate * bias


class XLSR(nn.Module):
    """``(B, n)`` waveforms -> ``(B, T, hidden)`` XLS-R features.

    ``features`` (the conv encoder, its LayerNorm and ``proj``) and
    ``encode`` (the positional conv, the layers, the final LayerNorm) are the
    two halves ``score/e2e.py`` puts under spans."""

    layer_type = EncoderLayer

    def __init__(self, cfg: XLSRConfig = XLSRConfig()):
        super().__init__()
        self.cfg = cfg
        self.conv = ConvFeatureEncoder(cfg)
        self.feature_norm = nn.LayerNorm(cfg.conv_dim, eps=cfg.eps)
        self.proj = nn.Linear(cfg.conv_dim, cfg.hidden)
        self.pos_conv = nn.Conv1d(cfg.hidden, cfg.hidden, cfg.pos_kernel, padding=cfg.pos_kernel // 2,
                                  groups=cfg.pos_groups)
        self.layers = nn.ModuleList(self.layer_type(cfg) for _ in range(cfg.layers))
        self.norm = nn.LayerNorm(cfg.hidden, eps=cfg.eps)

    def features(self, wav: torch.Tensor) -> torch.Tensor:
        if self.cfg.normalize:
            wav = F.layer_norm(wav, wav.shape[-1:])
        return self.proj(self.feature_norm(self.conv(wav)))

    def embed_positions(self, x: torch.Tensor) -> torch.Tensor:
        """The positional conv's output added to its input: the first
        layer's input."""
        pos = self.pos_conv(x.transpose(1, 2))
        if self.cfg.pos_kernel % 2 == 0:
            pos = pos[..., :-1]  # SamePad
        return x + F.gelu(pos).transpose(1, 2)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        h = self.embed_positions(x)
        for layer in self.layers:
            h = layer(h)
        return self.norm(h)

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        return self.encode(self.features(wav))


@lru_cache(maxsize=8)
def relative_buckets(t: int, buckets: int, max_distance: int, device: torch.device) -> torch.Tensor:
    """``(T, T)`` int64 bucket of key ``j`` for query ``i``, as the published
    ``_relative_positions_bucket`` computes it (float32 log on the host):
    each direction takes half the buckets, ``j > i`` the upper half; of a
    direction's ``n``, distances below ``n / 2`` are exact and the rest
    logarithmic up to ``max_distance``, the last bucket taking the farther
    ones. Integer and a function of T alone, so kept once per (T, device):
    every caller shares the one tensor and only reads it."""
    with torch.inference_mode(False):
        rel = torch.arange(t)[None, :] - torch.arange(t)[:, None]  # key minus query
        half = buckets // 2
        exact = half // 2
        a = rel.abs()
        far = exact + (torch.log(a.clamp(min=exact).float() / exact) / math.log(max_distance / exact)
                       * (half - exact)).long()
        out = (rel > 0).long() * half + torch.where(a < exact, a, far.clamp(max=half - 1))
        return out.to(device)


class WavLM(XLSR):
    """``(B, n)`` waveforms -> WavLM features (module docstring).
    ``hidden_states`` gives the 25 states a pooling back end reads: each
    layer's input, then the final LayerNorm of the last layer's output."""

    layer_type = GatedEncoderLayer

    def __init__(self, cfg: WavLMConfig = WAVLM_LARGE):
        super().__init__(cfg)
        self.rel_attn_embed = nn.Embedding(cfg.rel_buckets, cfg.heads)

    def position_bias(self, t: int, device: torch.device) -> torch.Tensor:
        """``P`` ``(H, T, T)``: each head's bias of every bucket, gathered."""
        idx = relative_buckets(t, self.cfg.rel_buckets, self.cfg.rel_max_distance, device)
        return self.rel_attn_embed(idx).permute(2, 0, 1).contiguous()

    def hidden_states(self, x: torch.Tensor) -> list[torch.Tensor]:
        h = self.embed_positions(x)
        with span("wavlm.position_bias"):
            position = self.position_bias(h.shape[1], h.device)
        states = []
        for layer in self.layers:
            states.append(h)
            h = layer(h, position)
        return states + [self.norm(h)]

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        return self.hidden_states(x)[-1]
