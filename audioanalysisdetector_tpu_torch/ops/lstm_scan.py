"""The LSTM recurrence of an inference scan, hidden 128, fp32: the hand-written Hopper kernel (K4).

The JAX package has no Pallas LSTM (XLA runs its scan); this kernel
replaces a library call, cuDNN's persistent LSTM under ``nn.LSTM`` /
``torch._VF.lstm``, where ``models/lstm.py::BiLSTM`` can observe that no
backward will be asked of it (``takes``). Its input is the input gates
``xg = x W_ih^T + b_ih + b_hh`` of every step (``input_gates``: one product
over the directions' stacked ``W_ih``, left to cuBLAS); the kernel runs all
T steps of the ``h W_hh^T`` recurrence and the cell, one launch for all the
given directions (the second runs backward in time), and writes either every
step's h into its direction's half of ``(B, T, n_dirs * 128)`` or only the
last step's, ``(B, n_dirs * 128)``. Design and bound: the note in
``ops/csrc/lstm_scan.cu``.

``lstm_scan`` launches the kernel on a CUDA tensor, under the ``lstm.scan``
span, and runs ``lstm_scan_reference`` (a step loop with the kernel's
arithmetic) on a CPU tensor. There is no fallback: a failed build or a
refused launch raises.
"""

from __future__ import annotations

import ctypes

import torch
from torch import nn

from audioanalysisdetector_tpu_torch.ops import _build, launch, on_card, refuse_grad
from audioanalysisdetector_tpu_torch.utils.profiling import span

HIDDEN = 128  # the one hidden size the kernel is built for
# lstm_scan_launch(xg, sxb, sxt, w0, w1, out, sob, sot, n_rows, T, n_dirs, last_only, stream)
_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
)


def refusals(x: torch.Tensor, lstm: nn.LSTM, lengths: torch.Tensor | None = None) -> list[str]:
    """Why the kernel cannot run ``lstm`` over ``x`` in place of cuDNN, each
    reason by name, or an empty list: it takes a fixed-length ``(B, T, I)``
    float32 batch on the card, hidden 128, and no backward (autograd would
    need one when grad mode is on and ``x`` or a parameter requires grad)."""
    why = []
    if not x.is_cuda:
        why.append("device")
    if x.dtype != torch.float32 or lstm.weight_hh_l0.dtype != torch.float32:
        why.append("dtype")
    if x.dim() != 3:
        why.append("shape")
    if lengths is not None:
        why.append("lengths")
    if lstm.hidden_size != HIDDEN:
        why.append("hidden")
    if torch.is_grad_enabled() and (x.requires_grad or any(p.requires_grad for p in lstm.parameters())):
        why.append("grad")
    return why


def takes(x: torch.Tensor, lstm: nn.LSTM, lengths: torch.Tensor | None = None) -> bool:
    """Whether ``BiLSTM`` runs ``lstm`` over ``x`` through the kernel."""
    return not refusals(x, lstm, lengths)


def input_gates(x: torch.Tensor, lstm: nn.LSTM, suffixes: tuple[str, ...]) -> torch.Tensor:
    """``(B, T, I)`` -> ``(B, T, 512 n)``: each direction's ``x W_ih^T + b_ih
    + b_hh`` side by side, for the directions of ``lstm`` named by their
    parameter suffixes (``""`` forward, ``"_reverse"`` backward), in one
    product over their stacked ``W_ih``."""
    B, T, I = x.shape
    w = torch.cat([getattr(lstm, f"weight_ih_l0{s}") for s in suffixes])
    b = torch.cat([getattr(lstm, f"bias_ih_l0{s}") + getattr(lstm, f"bias_hh_l0{s}") for s in suffixes])
    return torch.addmm(b, x.reshape(B * T, I), w.t()).view(B, T, -1)


def _check(xg: torch.Tensor, w_hh: tuple[torch.Tensor, ...]) -> None:
    if not 1 <= len(w_hh) <= 2:
        raise ValueError(f"lstm_scan runs one or two directions, got {len(w_hh)}")
    if xg.dim() != 3 or xg.shape[1] < 1 or xg.shape[2] != 4 * HIDDEN * len(w_hh):
        raise ValueError(f"expected (B, T >= 1, {4 * HIDDEN * len(w_hh)}) input gates, got {tuple(xg.shape)}")
    for w in w_hh:
        if w.shape != (4 * HIDDEN, HIDDEN) or w.dtype != xg.dtype or w.device != xg.device:
            raise ValueError(f"expected ({4 * HIDDEN}, {HIDDEN}) W_hh of the gates' dtype and device, "
                             f"got {tuple(w.shape)} {w.dtype} on {w.device}")


def lstm_scan_reference(
    xg: torch.Tensor, w_hh: tuple[torch.Tensor, ...], *, last_only: bool = False
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: for each direction d (the second
    backward in time), from h = c = 0, ``a = xg[:, p, 512 d :] + h W_hh^T``,
    ``c = sigmoid(a_f) c + sigmoid(a_i) tanh(a_g)``, ``h = sigmoid(a_o)
    tanh(c)`` -> ``(B, T, n_dirs * 128)``, or the last step's h of each
    direction, ``(B, n_dirs * 128)``."""
    _check(xg, w_hh)
    B, T, _ = xg.shape
    G = 4 * HIDDEN
    outs = []
    for d, w in enumerate(w_hh):
        h = c = xg.new_zeros(B, HIDDEN)
        steps = range(T - 1, -1, -1) if d else range(T)
        hs = [None] * T
        for p in steps:
            i, f, g, o = (xg[:, p, d * G : (d + 1) * G] + h @ w.t()).chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            hs[p] = h
        outs.append(h if last_only else torch.stack(hs, dim=1))
    return torch.cat(outs, dim=-1)


def lstm_scan(xg: torch.Tensor, w_hh: tuple[torch.Tensor, ...], *, last_only: bool = False) -> torch.Tensor:
    """``(B, T, n_dirs * 512)`` input gates and each direction's ``W_hh``
    ``(512, 128)`` (forward, then backward) -> the recurrence's output,
    ``(B, T, n_dirs * 128)``, or with ``last_only`` the last step's h of each
    direction, ``(B, n_dirs * 128)``. On a CUDA tensor one launch of the
    kernel on the current stream, counted as ``lstm_scan``; on a CPU tensor
    ``lstm_scan_reference``."""
    _check(xg, w_hh)
    if not on_card(xg, "lstm_scan"):
        return lstm_scan_reference(xg, w_hh, last_only=last_only)
    if xg.dtype != torch.float32:
        raise NotImplementedError(f"lstm_scan takes float32, got {xg.dtype}")
    for w in w_hh:
        refuse_grad(w, "lstm_scan")
    xg = xg.contiguous()
    w_hh = tuple(w.contiguous() for w in w_hh)
    B, T, _ = xg.shape
    n = len(w_hh)
    out = xg.new_empty((B, n * HIDDEN) if last_only else (B, T, n * HIDDEN))
    with span("lstm.scan"):
        launch(
            _build.entry_point("lstm_scan", "lstm_scan_launch", _ARGTYPES), xg, "lstm_scan",
            xg.data_ptr(), xg.stride(0), xg.stride(1), w_hh[0].data_ptr(), w_hh[-1].data_ptr(),
            out.data_ptr(), out.stride(0), 0 if last_only else out.stride(1), B, T, n, int(last_only),
            rows=B,
        )
    return out
