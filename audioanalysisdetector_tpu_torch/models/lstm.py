"""LSTM layers over ``(B, T, I)`` with the JAX package's semantics (PyTorch).

Counterpart of the JAX package's ``models/lstm.py``. The JAX layers
were built 1:1 with ``torch.nn.LSTM`` (gate order ``[i, f, g, o]``,
``weight_ih (4H, I)``, ``weight_hh (4H, H)``, two biases, zero initial
state), so fixed-length batches run ``torch.nn.LSTM`` itself (cuDNN on the
card). Ragged batches (``lengths``) keep the JAX contract: the backward
direction consumes each row's TRUE sequence reversed, and its output is
zero past each row's length, while the forward direction runs over the
whole padded row.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence

_LAST_ONLY_RAGGED = (
    "last_only only supports fixed-length batches; ragged rows need the "
    "full sequence + a length-indexed gather"
)


def _reverse_padded(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Reverse each row's first ``lengths[b]`` steps; zero the tail."""
    t = torch.arange(x.shape[1], device=x.device)
    idx = lengths.to(x.device)[:, None] - 1 - t[None, :]
    valid = idx >= 0
    gathered = torch.gather(
        x, 1, idx.clamp(0, x.shape[1] - 1)[:, :, None].expand(-1, -1, x.shape[2])
    )
    return torch.where(valid[:, :, None], gathered, torch.zeros((), dtype=x.dtype, device=x.device))


class LSTMLayer(nn.Module):
    """Unidirectional LSTM over ``(B, T, I) -> (B, T, H)``; ``reverse`` runs
    it backward in time."""

    def __init__(self, input_size: int, hidden: int, *, reverse: bool = False):
        super().__init__()
        self.hidden = hidden
        self.reverse = reverse
        self.lstm = nn.LSTM(input_size, hidden, batch_first=True)

    def forward(
        self,
        x: torch.Tensor,
        lengths: torch.Tensor | None = None,
        *,
        last_only: bool = False,
    ) -> torch.Tensor:
        if last_only and lengths is not None:
            raise ValueError(_LAST_ONLY_RAGGED)
        if not self.reverse:
            out, _ = self.lstm(x)
            return out[:, -1] if last_only else out
        if last_only:
            # the backward direction's value at T-1 is its first step from
            # the zero state
            out, _ = self.lstm(x[:, -1:])
            return out[:, 0]
        if lengths is None:
            out, _ = self.lstm(torch.flip(x, (1,)))
            return torch.flip(out, (1,))
        out, _ = self.lstm(_reverse_padded(x, lengths))
        return _reverse_padded(out, lengths)


class BiLSTM(nn.Module):
    """Bidirectional LSTM: ``(B, T, I) -> (B, T, 2H)`` (fwd ++ bwd).

    One ``torch.nn.LSTM(bidirectional=True)``; its ``_reverse`` tensors are
    the JAX ``bwd`` layer's."""

    def __init__(self, input_size: int, hidden: int):
        super().__init__()
        self.hidden = hidden
        self.lstm = nn.LSTM(input_size, hidden, batch_first=True, bidirectional=True)

    def forward(
        self,
        x: torch.Tensor,
        lengths: torch.Tensor | None = None,
        *,
        last_only: bool = False,
    ) -> torch.Tensor:
        """Full output ``(B, T, 2H)``; with ``last_only`` (fixed-length
        batches only) just position T-1, ``(B, 2H)``."""
        if last_only and lengths is not None:
            raise ValueError(_LAST_ONLY_RAGGED)
        out, _ = self.lstm(x)
        if last_only:
            return out[:, -1]
        if lengths is None:
            return out
        # backward half over each row's true sequence: a packed run reverses
        # within each length and leaves zeros past it (_reverse_padded's rule)
        packed = pack_padded_sequence(
            x, lengths.to("cpu", torch.int64), batch_first=True, enforce_sorted=False
        )
        ragged, _ = pad_packed_sequence(
            self.lstm(packed)[0], batch_first=True, total_length=x.shape[1]
        )
        H = self.hidden
        return torch.cat([out[..., :H], ragged[..., H:]], dim=-1)
