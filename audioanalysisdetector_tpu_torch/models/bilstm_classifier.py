"""Stacked BiLSTM classifier — the GMM⊕BiLSTM fusion system's neural half (PyTorch).

Counterpart of the JAX package's ``models/bilstm_classifier.py``
(the reference's ``BiLSTMClassifier``, reference/ASV_dl_func.py:1427-1445):
two stacked bidirectional LSTMs (hidden 128), dropout 0.3 between and
after, last-timestep readout, linear head to 2 logits. Input is time-major
CQCC ``(B, T, F)`` (F = 19 after ``transpose_cqcc``).

The reference reads ``out[:, -1, :]``, the *final padded* timestep, exact
for the fixed-length 2-s chunks it trains on. With ``lengths`` each
sequence's true last step is read instead. The fixed-length readout
computes only position T-1 of the second BiLSTM, as the JAX package does:
its forward scan and one backward cell step (``BiLSTM(last_only=True)``).
Dropout draws its masks from the ``generator`` handed to ``forward``
(``models.layers.Dropout``).
"""

from __future__ import annotations

import torch
from torch import nn

from audioanalysisdetector_tpu_torch.models.layers import Dropout
from audioanalysisdetector_tpu_torch.models.lstm import BiLSTM


class BiLSTMClassifier(nn.Module):
    """``(B, T, input_dim)`` -> ``(B, num_classes)`` logits. flax infers the
    input width at init; torch needs it here (``input_dim``, 19 CQCCs)."""

    def __init__(self, hidden: int = 128, num_classes: int = 2, dropout: float = 0.3,
                 input_dim: int = 19):
        super().__init__()
        self.hidden = hidden
        self.bilstm1 = BiLSTM(input_dim, hidden)
        self.bilstm2 = BiLSTM(2 * hidden, hidden)
        self.dropout = Dropout(dropout)
        self.fc = nn.Linear(2 * hidden, num_classes)

    def forward(
        self,
        x: torch.Tensor,
        lengths: torch.Tensor | None = None,
        *,
        generator: torch.Generator | None = None,
    ) -> torch.Tensor:
        """``generator`` feeds the two dropout masks in training mode."""
        h = self.dropout(self.bilstm1(x, lengths), generator)
        if lengths is None:
            last = self.bilstm2(h, last_only=True)
        else:
            h = self.bilstm2(h, lengths)
            idx = (lengths.to(h.device) - 1).clamp(0, h.shape[1] - 1)
            last = h[torch.arange(h.shape[0], device=h.device), idx]
        return self.fc(self.dropout(last, generator))
