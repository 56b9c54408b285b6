"""CNN-BiLSTM hybrid with attention — the flagship model (PyTorch).

Counterpart of the JAX package's ``models/cnn_bilstm.py``, with the
same two reference quirks kept as numeric contract:

1. The Conv1d treats the *time frames* as input channels and the feature
   axis as the sequence. The public input stays the JAX layout
   ``(B, n_feat, T)``; it is permuted to torch's ``(B, C=T, L=n_feat)``
   inside. Flax infers the channel count from the input, torch cannot, so
   ``in_channels`` is the frame count T (63 in the parity mel profile, 126
   in the speech profile).
2. ``LayerNorm(1)`` on the softmax attention weights normalizes over a
   singleton axis, which collapses every weight to the LayerNorm *bias*.
   ``fixed_attention=True`` gives the evidently-intended softmax attention.
   The layer computes flax's arithmetic (``_flax_layer_norm``): its output
   is the bias exactly, as ``nn.LayerNorm``'s is, and so are its gradients
   zero exactly, where torch's kernel leaves rounding noise in them that
   Adam would turn into full steps of the attention and the LayerNorm scale.

BatchNorm: flax ``momentum=0.9`` is torch ``momentum=0.1``, ``eps=1e-5``; in
training mode its running variance takes the biased batch variance, as
flax's does (``models.layers.FlaxBatchNorm1d``); ``bn_axis_name`` makes it
flax's sync-BN over the ranks bound to that mesh axis. Dropout draws its masks
from the ``generator`` handed to ``forward`` (``models.layers.Dropout``).
"""

from __future__ import annotations

import torch
from torch import nn

from audioanalysisdetector_tpu_torch.models.layers import Dropout, FlaxBatchNorm1d
from audioanalysisdetector_tpu_torch.models.lstm import BiLSTM


def _flax_layer_norm(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    """flax's LayerNorm over the last axis with ``ln``'s scale, bias and eps:
    ``(x - E[x]) rsqrt(E[x^2] - E[x]^2 + eps)``, the variance clipped at 0."""
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x * x).mean(dim=-1, keepdim=True) - mean * mean).clamp_min(0.0)
    return (x - mean) * torch.rsqrt(var + ln.eps) * ln.weight + ln.bias


class CNNBiLSTMHybrid(nn.Module):
    def __init__(
        self,
        in_channels: int,
        *,
        lstm_units: int = 32,
        dense_units: int = 64,
        dropout_rate: float = 0.5,
        conv_dropout: float = 0.3,
        fixed_attention: bool = False,
        logits: bool = False,  # True: return pre-sigmoid logits (stable BCE)
        bn_axis_name: str | None = None,  # the mesh axis for sync-BN under data parallelism
    ):
        super().__init__()
        self.fixed_attention = fixed_attention
        self.logits = logits
        self.conv = nn.Conv1d(in_channels, 64, kernel_size=3, padding=1)
        self.bn = FlaxBatchNorm1d(64, eps=1e-5, momentum=0.1, axis_name=bn_axis_name)
        self.pool = nn.MaxPool1d(2, 2)
        self.conv_dropout = Dropout(conv_dropout)
        self.bilstm = BiLSTM(64, lstm_units)
        self.attention = nn.Linear(2 * lstm_units, 1)
        if not fixed_attention:
            self.layer_norm = nn.LayerNorm(1, eps=1e-5)
        self.fc1 = nn.Linear(2 * lstm_units, dense_units)
        self.dropout = Dropout(dropout_rate)
        self.fc2 = nn.Linear(dense_units, 1)

    def forward(self, x: torch.Tensor, *, generator: torch.Generator | None = None) -> torch.Tensor:
        """``(B, n_feat, T)`` -> ``(B, 1)`` sigmoid scores (or logits).
        ``generator`` feeds the dropout masks in training mode."""
        h = self.conv(x.transpose(1, 2))  # (B, 64, n_feat)
        h = torch.relu(self.bn(h))
        h = self.conv_dropout(self.pool(h), generator)  # (B, 64, n_feat // 2)
        lstm_out = self.bilstm(h.transpose(1, 2))  # (B, n_feat // 2, 2H)
        attn = torch.softmax(self.attention(lstm_out), dim=1)
        if not self.fixed_attention:
            attn = _flax_layer_norm(attn, self.layer_norm)  # the singleton-axis quirk
        pooled = torch.amax(lstm_out * attn, dim=1)  # (B, 2H)
        h = self.dropout(torch.relu(self.fc1(pooled)), generator)
        out = self.fc2(h)
        return out if self.logits else torch.sigmoid(out)
