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

BatchNorm: flax ``momentum=0.9`` is torch ``momentum=0.1``, ``eps=1e-5``.
"""

from __future__ import annotations

import torch
from torch import nn

from audioanalysisdetector_tpu_torch.models.lstm import BiLSTM


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
    ):
        super().__init__()
        self.fixed_attention = fixed_attention
        self.logits = logits
        self.conv = nn.Conv1d(in_channels, 64, kernel_size=3, padding=1)
        self.bn = nn.BatchNorm1d(64, eps=1e-5, momentum=0.1)
        self.pool = nn.MaxPool1d(2, 2)
        self.conv_dropout = nn.Dropout(conv_dropout)
        self.bilstm = BiLSTM(64, lstm_units)
        self.attention = nn.Linear(2 * lstm_units, 1)
        if not fixed_attention:
            self.layer_norm = nn.LayerNorm(1, eps=1e-5)
        self.fc1 = nn.Linear(2 * lstm_units, dense_units)
        self.dropout = nn.Dropout(dropout_rate)
        self.fc2 = nn.Linear(dense_units, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``(B, n_feat, T)`` -> ``(B, 1)`` sigmoid scores (or logits)."""
        h = self.conv(x.transpose(1, 2))  # (B, 64, n_feat)
        h = torch.relu(self.bn(h))
        h = self.conv_dropout(self.pool(h))  # (B, 64, n_feat // 2)
        lstm_out = self.bilstm(h.transpose(1, 2))  # (B, n_feat // 2, 2H)
        attn = torch.softmax(self.attention(lstm_out), dim=1)
        if not self.fixed_attention:
            attn = self.layer_norm(attn)  # the singleton-axis quirk
        pooled = torch.amax(lstm_out * attn, dim=1)  # (B, 2H)
        h = self.dropout(torch.relu(self.fc1(pooled)))
        out = self.fc2(h)
        return out if self.logits else torch.sigmoid(out)
