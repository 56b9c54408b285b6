"""Decibel conversions with librosa-parity semantics (PyTorch).

Counterpart of the JAX package's ``frontend/db.py``. ``ref="max"``
is a *per-utterance* reference: the max is taken over each utterance's own
trailing ``utt_axes`` axes, never over the whole batch; ``top_db`` clipping
is per utterance too.

At the parity profile on the card, ``log_mel_spectrogram`` and
``ct_log_mel`` do not call ``power_to_db`` where ``ops.ct_mel.db_refusals``
names no reason: K3's dB instance (``ops.ct_mel.ct_mel_db``) computes it in
its epilogue, in this function's order and roundings.
"""

from __future__ import annotations

import torch


def power_to_db(
    S: torch.Tensor,
    *,
    ref: float | str = 1.0,
    amin: float = 1e-10,
    top_db: float | None = 80.0,
    utt_axes: int = 2,
) -> torch.Tensor:
    """``10*log10(S/ref)`` with optional per-utterance max reference.

    Args:
      S: power spectrogram ``(..., n_freq, n_frames)`` (non-negative).
      ref: scalar reference, or ``"max"`` for the per-utterance maximum.
      amin: floor for both ``S`` and ``ref``.
      top_db: clip to ``max - top_db`` per utterance (None disables).
      utt_axes: how many trailing axes form one utterance's spectrogram.
    """
    dims = tuple(range(-utt_axes, 0))
    log_spec = 10.0 * torch.log10(torch.clamp(S, min=amin))
    if ref == "max":
        ref_val = torch.amax(S, dim=dims, keepdim=True)
    else:
        ref_val = torch.tensor(float(ref), dtype=S.dtype, device=S.device)
    log_spec = log_spec - 10.0 * torch.log10(torch.clamp(ref_val, min=amin))
    if top_db is not None:
        if top_db < 0:
            raise ValueError("top_db must be non-negative")
        peak = torch.amax(log_spec, dim=dims, keepdim=True)
        log_spec = torch.maximum(log_spec, peak - top_db)
    return log_spec


def amplitude_to_db(
    S: torch.Tensor,
    *,
    ref: float | str = 1.0,
    amin: float = 1e-5,
    top_db: float | None = 80.0,
    utt_axes: int = 2,
) -> torch.Tensor:
    """``20*log10(S/ref)`` — librosa semantics: power_to_db of the squares."""
    ref_sq = "max" if ref == "max" else float(ref) ** 2
    return power_to_db(
        S * S, ref=ref_sq, amin=amin * amin, top_db=top_db, utt_axes=utt_axes
    )
