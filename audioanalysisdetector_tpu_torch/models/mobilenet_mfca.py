"""MobileNetV2 + MFCA — the notebook-only spectrogram classifier (PyTorch).

Counterpart of the JAX package's ``models/mobilenet_mfca.py``
(``AudioDeepfakeModel``, ASV_deep_learning.ipynb cell 28): MobileNetV2
features with a 1-channel stem, built from the published table (inverted
residual bottlenecks, ReLU6, width 1.0, no pretrained weights), the 1280
channels split into low/mid/high thirds (426, 426, 428), an "MFCA"
squeeze-excitation with a DCT/IDCT round trip on the attention vector,
global average pool, 1280->256->2 head.

The DCT is an orthonormal matmul on the port's ``frontend.dct.dct_ii_matrix``.
On the ``(B, C, 1, 1)`` attention vector the round trip is the identity, so
the attention is ``sigmoid(y + idct(dct(y))) == sigmoid(2 y)``; it is
computed as the JAX package computes it.

Module names are the flax tree's ``nn.compact`` auto-names
(``features._ConvBNReLU_0.Conv_0``, ``features.InvertedResidual_k
._ConvBNReLU_j``, ``mfca.Dense_0``), so the flax layout maps name for name
(``convert.py``). The input is channel-last ``(B, H, W[, 1])``; inside the
maps are NCHW. BatchNorm is flax's rule with eps 1e-3
(``models.layers.FlaxBatchNorm2d``); dropout draws its mask from the
``generator`` handed to ``forward``.
"""

from __future__ import annotations

import torch
from torch import nn

from audioanalysisdetector_tpu_torch.frontend.dct import dct_ii_matrix
from audioanalysisdetector_tpu_torch.models.layers import Dropout, FlaxBatchNorm2d

# (expansion t, out channels c, repeats n, stride s) — MobileNetV2 table 2
_INVERTED_RESIDUAL_CFG = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)


def _relu6(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, 0.0, 6.0)


def _bn(features: int) -> FlaxBatchNorm2d:
    return FlaxBatchNorm2d(features, eps=1e-3, momentum=0.1)


class _ConvBNReLU(nn.Module):
    def __init__(self, in_features: int, features: int, kernel: int = 3, stride: int = 1, groups: int = 1):
        super().__init__()
        self.Conv_0 = nn.Conv2d(in_features, features, kernel, stride=stride, padding=(kernel - 1) // 2,
                                groups=groups, bias=False)
        self.BatchNorm_0 = _bn(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _relu6(self.BatchNorm_0(self.Conv_0(x)))


class InvertedResidual(nn.Module):
    def __init__(self, in_features: int, features: int, stride: int, expand: int):
        super().__init__()
        hidden = in_features * expand
        layers = [_ConvBNReLU(in_features, hidden, kernel=1)] if expand != 1 else []
        layers.append(_ConvBNReLU(hidden, hidden, kernel=3, stride=stride, groups=hidden))
        for i, layer in enumerate(layers):
            self.add_module(f"_ConvBNReLU_{i}", layer)
        self.n_conv_bn = len(layers)
        self.Conv_0 = nn.Conv2d(hidden, features, 1, bias=False)
        self.BatchNorm_0 = _bn(features)
        self.residual = stride == 1 and in_features == features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for i in range(self.n_conv_bn):
            h = getattr(self, f"_ConvBNReLU_{i}")(h)
        h = self.BatchNorm_0(self.Conv_0(h))
        return x + h if self.residual else h


class MobileNetV2Features(nn.Module):
    """Feature trunk with a single-channel stem: ``(B, 1, H, W) -> (B, 1280, h, w)``."""

    def __init__(self):
        super().__init__()
        self._ConvBNReLU_0 = _ConvBNReLU(1, 32, kernel=3, stride=2)
        k, c_in = 0, 32
        for t, c, n, s in _INVERTED_RESIDUAL_CFG:
            for i in range(n):
                self.add_module(f"InvertedResidual_{k}", InvertedResidual(c_in, c, s if i == 0 else 1, t))
                k, c_in = k + 1, c
        self.n_blocks = k
        self._ConvBNReLU_1 = _ConvBNReLU(c_in, 1280, kernel=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self._ConvBNReLU_0(x)
        for k in range(self.n_blocks):
            h = getattr(self, f"InvertedResidual_{k}")(h)
        return self._ConvBNReLU_1(h)


def _basis(n: int, x: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(dct_ii_matrix(n), dtype=x.dtype, device=x.device)


def dct_2d(x: torch.Tensor) -> torch.Tensor:
    """Orthonormal DCT-II over the last two axes (two matmuls)."""
    return torch.einsum("ij,...jk,lk->...il", _basis(x.shape[-2], x), x, _basis(x.shape[-1], x))


def idct_2d(x: torch.Tensor) -> torch.Tensor:
    """The inverse of ``dct_2d`` (the transposed bases)."""
    return torch.einsum("ji,...jk,kl->...il", _basis(x.shape[-2], x), x, _basis(x.shape[-1], x))


class MFCAModule(nn.Module):
    """Multi-frequency channel attention (the reference's SE + DCT round
    trip) over NCHW maps."""

    def __init__(self, channels: int = 1280, reduction: int = 16):
        super().__init__()
        self.Dense_0 = nn.Linear(channels, channels // reduction)
        self.Dense_1 = nn.Linear(channels // reduction, channels)

    def forward(self, x_low: torch.Tensor, x_mid: torch.Tensor, x_high: torch.Tensor) -> torch.Tensor:
        x = torch.cat([x_low, x_mid, x_high], dim=1)  # (B, C, h, w)
        y = x.mean(dim=(2, 3))  # squeeze
        y = torch.sigmoid(self.Dense_1(torch.relu(self.Dense_0(y))))  # (B, C)
        y_rt = idct_2d(dct_2d(y[:, :, None, None]))[:, :, 0, 0]  # == y for 1x1
        attn = torch.sigmoid(y + y_rt)
        return x * attn[:, :, None, None]


class MobileNetMFCA(nn.Module):
    """features -> thirds -> MFCA -> pool -> 1280->256->num_classes."""

    def __init__(self, num_classes: int = 2, dropout: float = 0.3):
        super().__init__()
        self.features = MobileNetV2Features()
        self.mfca = MFCAModule(1280)
        self.fc1 = nn.Linear(1280, 256)
        self.dropout = Dropout(dropout)
        self.fc2 = nn.Linear(256, num_classes)

    def forward(self, x: torch.Tensor, *, generator: torch.Generator | None = None) -> torch.Tensor:
        """``(B, H, W[, 1])`` -> ``(B, num_classes)`` logits."""
        x = x[:, None] if x.dim() == 3 else x.permute(0, 3, 1, 2)
        feats = self.features(x)
        c = feats.shape[1]
        fused = self.mfca(feats[:, : c // 3], feats[:, c // 3 : 2 * c // 3], feats[:, 2 * c // 3 :])
        h = torch.relu(self.fc1(fused.mean(dim=(2, 3))))
        return self.fc2(self.dropout(h, generator))
