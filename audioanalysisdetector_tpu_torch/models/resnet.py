"""Anti-spoofing ResNet family — 2-D feature-map classifiers (PyTorch).

Counterpart of the JAX package's ``models/resnet.py`` (the reference's
residual models, reference/ASV_dl_func.py:541-641, 708-743):

- ``ResidualBlock``: conv3x3 -> BN -> LeakyReLU(0.01) -> channel dropout ->
  conv3x3(stride), summed with a 1x1-conv + BN shortcut where the block
  changes stride or width, then BN and LeakyReLU AFTER the residual add (the
  reference's order, kept). The 1x1 stride-3 shortcut has flax's ``SAME``
  padding, which is 0 for a 1x1 kernel.
- ``AntiSpoofingResNet``: 1->32 stem, six 32->32 blocks (the first at stride
  3), global average pool, 32->256->num_classes head; ``feature_maps`` /
  ``classify_features`` split it at the last block for Grad-CAM.
- ``ExtractFeatureResidual`` / ``MoreFeaturesClassifier``: the same trunk
  ending in a 64-d embedding, ONE extractor shared by three feature maps
  whose embeddings concat into a 192->128->256->2 MLP.

The boundary is the JAX package's channel-last ``(B, H, W[, C])``: a 3-D
input gets a channel axis; ``feature_maps`` returns ``(B, H', W', C)``
(64 x 63 -> 22 x 21 x 32). Inside, the maps are NCHW for cuDNN.

Module names follow the flax tree (``trunk.block0.conv1`` is
``trunk/block0/conv1``); flax creates parameters only for submodules that
are called, so only ``block0`` (stride 3) has ``shortcut_conv`` /
``shortcut_bn``, and so here. The JAX trunk builds its blocks with dropout
0.5 whatever the model's ``dropout`` (``resnet.py:80-83`` there), and the
extractor hard-codes 0.5: kept. BatchNorm is flax's rule
(``models.layers.FlaxBatchNorm2d``, momentum 0.9, eps 1e-5); dropout masks
come from the ``generator`` handed to ``forward``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from audioanalysisdetector_tpu_torch.models.layers import ChannelDropout, Dropout, FlaxBatchNorm2d


def _leaky(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=0.01)


def _bn(features: int) -> FlaxBatchNorm2d:
    return FlaxBatchNorm2d(features, eps=1e-5, momentum=0.1)


class ResidualBlock(nn.Module):
    def __init__(self, in_features: int = 32, features: int = 32, stride: int = 1, dropout: float = 0.5):
        super().__init__()
        self.conv1 = nn.Conv2d(in_features, features, 3, padding=1, bias=False)
        self.bn1 = _bn(features)
        self.drop = ChannelDropout(dropout)
        self.conv2 = nn.Conv2d(features, features, 3, stride=stride, padding=1, bias=False)
        self.bn2 = _bn(features)
        self.projects = stride != 1 or in_features != features
        if self.projects:
            self.shortcut_conv = nn.Conv2d(in_features, features, 1, stride=stride, bias=False)
            self.shortcut_bn = _bn(features)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        out = _leaky(self.bn1(self.conv1(x)))
        out = self.conv2(self.drop(out, generator))
        shortcut = self.shortcut_bn(self.shortcut_conv(x)) if self.projects else x
        return _leaky(self.bn2(out + shortcut))  # post-add BN (reference order)


STRIDES = (3, 1, 1, 1, 1, 1)


class ResNetTrunk(nn.Module):
    """Stem + six residual blocks over NCHW maps; pooled or spatial output."""

    def __init__(self, features: int = 32):
        super().__init__()
        self.stem_conv = nn.Conv2d(1, features, 3, padding=1, bias=False)
        self.stem_bn = _bn(features)
        for i, s in enumerate(STRIDES):
            self.add_module(f"block{i}", ResidualBlock(features, features, stride=s))

    def forward(
        self, x: torch.Tensor, generator: torch.Generator | None = None, *, pool: bool = True
    ) -> torch.Tensor:
        h = _leaky(self.stem_bn(self.stem_conv(x)))
        for i in range(len(STRIDES)):
            h = getattr(self, f"block{i}")(h, generator)
        return h.mean(dim=(2, 3)) if pool else h  # AdaptiveAvgPool2d((1, 1)) + flatten


def _nchw(x: torch.Tensor) -> torch.Tensor:
    """Channel-last ``(B, H, W[, C])`` -> NCHW."""
    return x[:, None] if x.dim() == 3 else x.permute(0, 3, 1, 2)


class AntiSpoofingResNet(nn.Module):
    def __init__(self, num_classes: int = 2, dropout: float = 0.5):
        super().__init__()
        self.trunk = ResNetTrunk()
        self.fc1 = nn.Linear(32, 256)
        self.drop = Dropout(dropout)
        self.fc2 = nn.Linear(256, num_classes)

    def _head(self, h: torch.Tensor, generator: torch.Generator | None) -> torch.Tensor:
        return self.fc2(_leaky(self.drop(self.fc1(h), generator)))

    def forward(self, x: torch.Tensor, *, generator: torch.Generator | None = None) -> torch.Tensor:
        """``(B, H, W[, C])`` -> ``(B, num_classes)`` logits."""
        return self._head(self.trunk(_nchw(x), generator), generator)

    def feature_maps(self, x: torch.Tensor) -> torch.Tensor:
        """The last residual block's output ``(B, H', W', 32)``; call it in
        eval mode, as the JAX method runs ``train=False``."""
        return self.trunk(_nchw(x), pool=False).permute(0, 2, 3, 1)

    def classify_features(self, fmap: torch.Tensor) -> torch.Tensor:
        """Resume the forward from ``feature_maps``' output (eval mode)."""
        return self._head(fmap.mean(dim=(1, 2)), None)


class ExtractFeatureResidual(nn.Module):
    """Trunk ending in a 64-d embedding (reference/ASV_dl_func.py:582-616)."""

    def __init__(self):
        super().__init__()
        self.trunk = ResNetTrunk()
        self.fc1 = nn.Linear(32, 256)
        self.drop = Dropout(0.5)
        self.fc2 = nn.Linear(256, 64)

    def forward(self, x: torch.Tensor, *, generator: torch.Generator | None = None) -> torch.Tensor:
        h = self.fc1(self.trunk(_nchw(x), generator))
        return self.fc2(_leaky(self.drop(h, generator)))


class MoreFeaturesClassifier(nn.Module):
    """Three feature maps through ONE shared extractor, concat -> MLP -> 2
    (the reference shares a single ``ExtractFeatureResidual`` across the
    inputs, reference/ASV_dl_func.py:633-638). In training mode the shared
    BatchNorm statistics move once per input, in input order, as flax's do."""

    def __init__(self, num_classes: int = 2):
        super().__init__()
        self.extractor = ExtractFeatureResidual()
        self.fc1 = nn.Linear(192, 128)
        self.drop1 = Dropout(0.5)
        self.fc2 = nn.Linear(128, 256)
        self.drop2 = Dropout(0.5)
        self.fc3 = nn.Linear(256, num_classes)

    def forward(
        self, x1: torch.Tensor, x2: torch.Tensor, x3: torch.Tensor, *,
        generator: torch.Generator | None = None,
    ) -> torch.Tensor:
        emb = torch.cat([self.extractor(x, generator=generator) for x in (x1, x2, x3)], dim=-1)  # (B, 192)
        h = _leaky(self.drop1(self.fc1(emb), generator))
        h = _leaky(self.drop2(self.fc2(h), generator))
        return self.fc3(h)
