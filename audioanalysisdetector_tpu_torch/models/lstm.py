"""LSTM layers over ``(B, T, I)`` with the JAX package's semantics (PyTorch).

Counterpart of the JAX package's ``models/lstm.py``. The JAX layers
were built 1:1 with ``torch.nn.LSTM`` (gate order ``[i, f, g, o]``,
``weight_ih (4H, I)``, ``weight_hh (4H, H)``, two biases, zero initial
state), so the full output of a fixed-length batch is ``torch.nn.LSTM``'s
own (cuDNN on the card). Ragged batches (``lengths``) keep the JAX
contract: the backward direction consumes each row's TRUE sequence
reversed, and its output is zero past each row's length, while the forward
direction runs over the whole padded row.

``last_only`` computes what the JAX package computes for position T-1, and
nothing else: the forward direction over all T steps (the functional LSTM
on the module's forward tensors, cuDNN on the card) and the backward
direction's first step from the zero state on ``x[:, -1]`` (one cell
evaluation, ``_first_backward_step``). Both read the module's parameters
at each call; the state-dict keys are ``torch.nn.LSTM``'s. The forward
scan calls ``torch._VF.lstm``, a private API (it passed on torch 2.13 on
the CPU and 2.11 on the card).

``BiLSTM``'s scans go to the hand-written recurrence K4
(``ops/lstm_scan.py``) in place of cuDNN where ``lstm_scan.takes`` holds of
its input: a fixed-length float32 batch on the card, hidden 128, and no
backward to come (inference: the fused scorer's classifier). The full
output is then one K4 launch for both directions, ``last_only``'s forward
scan one launch for the forward direction alone. Every other input
(training, XAI's gradients, ragged rows, the mel model's hidden 32, other
dtypes, the CPU) keeps the paths above.
"""

from __future__ import annotations

import torch
from torch import _VF, nn
from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence

from audioanalysisdetector_tpu_torch.ops import lstm_scan as k4
from audioanalysisdetector_tpu_torch.utils.profiling import span

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


def _first_backward_step(x: torch.Tensor, lstm: nn.LSTM, suffix: str = "") -> torch.Tensor:
    """The backward direction's output at T-1, ``(B, H)``: its first step
    from the zero state, which reads ``x[:, -1]`` alone, on ``lstm``'s
    ``*_l0{suffix}`` tensors. The cell keeps its ``h0 @ W_hh`` term so
    ``weight_hh`` gets the zero gradient the full output gives it, not none."""
    h0 = x.new_zeros(x.shape[0], lstm.hidden_size)
    h, _ = torch.lstm_cell(
        x[:, -1], (h0, h0), getattr(lstm, f"weight_ih_l0{suffix}"), getattr(lstm, f"weight_hh_l0{suffix}"),
        getattr(lstm, f"bias_ih_l0{suffix}"), getattr(lstm, f"bias_hh_l0{suffix}"),
    )
    return h


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
            return _first_backward_step(x, self.lstm)
        if lengths is None:
            out, _ = self.lstm(torch.flip(x, (1,)))
            return torch.flip(out, (1,))
        out, _ = self.lstm(_reverse_padded(x, lengths))
        return _reverse_padded(out, lengths)


class BiLSTM(nn.Module):
    """Bidirectional LSTM: ``(B, T, I) -> (B, T, 2H)`` (fwd ++ bwd).

    One ``torch.nn.LSTM(bidirectional=True)`` holds the weights; its
    ``_reverse`` tensors are the JAX ``bwd`` layer's."""

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
        batches only) just position T-1, ``(B, 2H)``. Every route runs
        under the ``lstm.layer`` span."""
        if last_only and lengths is not None:
            raise ValueError(_LAST_ONLY_RAGGED)
        with span("lstm.layer"):
            if last_only:
                return self._last(x)
            if k4.takes(x, self.lstm, lengths):
                return self._scan(x)
            out, _ = self.lstm(x)
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

    def _scan(self, x: torch.Tensor, *, last_only: bool = False) -> torch.Tensor:
        """K4's route: both directions' full output ``(B, T, 2H)`` in one
        launch, or with ``last_only`` the forward direction's last h ``(B,
        H)`` (on a CPU tensor, K4's plain version)."""
        lstm = self.lstm
        if last_only:
            return k4.lstm_scan(k4.input_gates(x, lstm, ("",)), (lstm.weight_hh_l0,), last_only=True)
        xg = k4.input_gates(x, lstm, ("", "_reverse"))
        return k4.lstm_scan(xg, (lstm.weight_hh_l0, lstm.weight_hh_l0_reverse))

    def _last(self, x: torch.Tensor) -> torch.Tensor:
        """Position T-1 of the full output: the forward direction's last
        step, and the backward direction's first step from the zero state."""
        lstm = self.lstm
        if k4.takes(x, lstm):
            return torch.cat([self._scan(x, last_only=True), _first_backward_step(x, lstm, "_reverse")], dim=-1)
        h0 = x.new_zeros(1, x.shape[0], self.hidden)
        fwd = [lstm.weight_ih_l0, lstm.weight_hh_l0, lstm.bias_ih_l0, lstm.bias_hh_l0]
        # one chunk in cuDNN's order for one direction: the module's flat
        # buffer interleaves the two directions, and cuDNN would compact the
        # four tensors itself and warn on every call
        flat = torch.cat([p.reshape(-1) for p in fwd]).split([p.numel() for p in fwd])
        fwd = [v.view_as(p) for v, p in zip(flat, fwd)]
        _, h_fwd, _ = _VF.lstm(x, (h0, h0), fwd, True, 1, 0.0, lstm.training, False, True)  # private API
        return torch.cat([h_fwd[0], _first_backward_step(x, lstm, "_reverse")], dim=-1)
