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
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn


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


class ConvFeatureEncoder(nn.Module):
    """``(B, n)`` waveforms -> ``(B, T, conv_dim)`` frames, time-major."""

    def __init__(self, cfg: XLSRConfig):
        super().__init__()
        dims = [1] + [cfg.conv_dim] * len(cfg.conv_kernels)
        self.convs = nn.ModuleList(
            nn.Conv1d(dims[i], dims[i + 1], k, stride=s)
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

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        b, t, d = h.shape
        x = self.attn_norm(h)

        def split(y: torch.Tensor) -> torch.Tensor:
            return y.view(b, t, self.heads, d // self.heads).transpose(1, 2)

        # scaled by head_dim ** -0.5, as fairseq scales q
        a = F.scaled_dot_product_attention(split(self.q(x)), split(self.k(x)), split(self.v(x)))
        h = h + self.out(a.transpose(1, 2).reshape(b, t, d))
        return h + self.fc2(F.gelu(self.fc1(self.ffn_norm(h))))


class XLSR(nn.Module):
    """``(B, n)`` waveforms -> ``(B, T, hidden)`` XLS-R features.

    ``features`` (the conv encoder, its LayerNorm and ``proj``) and
    ``encode`` (the positional conv, the layers, the final LayerNorm) are the
    two halves ``score/e2e.py`` puts under spans."""

    def __init__(self, cfg: XLSRConfig = XLSRConfig()):
        super().__init__()
        self.cfg = cfg
        self.conv = ConvFeatureEncoder(cfg)
        self.feature_norm = nn.LayerNorm(cfg.conv_dim, eps=cfg.eps)
        self.proj = nn.Linear(cfg.conv_dim, cfg.hidden)
        self.pos_conv = nn.Conv1d(cfg.hidden, cfg.hidden, cfg.pos_kernel, padding=cfg.pos_kernel // 2,
                                  groups=cfg.pos_groups)
        self.layers = nn.ModuleList(EncoderLayer(cfg) for _ in range(cfg.layers))
        self.norm = nn.LayerNorm(cfg.hidden, eps=cfg.eps)

    def features(self, wav: torch.Tensor) -> torch.Tensor:
        return self.proj(self.feature_norm(self.conv(wav)))

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        pos = self.pos_conv(x.transpose(1, 2))
        if self.cfg.pos_kernel % 2 == 0:
            pos = pos[..., :-1]  # SamePad
        h = x + F.gelu(pos).transpose(1, 2)
        for layer in self.layers:
            h = layer(h)
        return self.norm(h)

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        return self.encode(self.features(wav))
