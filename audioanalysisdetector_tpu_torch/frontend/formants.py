"""Formant tracking + silence analysis — the Praat-based prosodic features (PyTorch).

Counterpart of the JAX package's ``frontend/formants.py`` and of the
reference's ``analyze_formants_and_silence`` (reference/ASV_dl_func.py:343-401),
which uses parselmouth/Praat for intensity and Burg formant tracking and
returns 10 scalar features: silence ratio, per-formant segment
counts/durations, and a vocal-tract-length proxy ``35000 / (4 * F1)``.

The same published methods as the JAX package: frame intensity in dB SPL
re 20 µPa; Burg's-method LPC per 25 ms frame with pre-emphasis; formants
from the LPC polynomial roots. The Burg recursion runs batched on
``device`` (a Python loop over the static order, each stage the masked
update of the JAX package's ``fori_loop`` body); the polynomial
root-finding runs on the host (``np.roots``, a non-symmetric eigensolve), as
in the JAX package: this feature feeds only the classical path.
"""

from __future__ import annotations

import numpy as np
import torch

from audioanalysisdetector_tpu_torch.frontend.windows import get_window

_P_REF = 2e-5  # 20 µPa, Praat's dB SPL reference


def intensity_db(
    y: torch.Tensor, sr: int, *, frame_seconds: float = 0.04, hop_seconds: float = 0.01
) -> torch.Tensor:
    """Frame RMS intensity in dB SPL: (..., n) -> (..., n_frames).

    Inputs shorter than one analysis window raise."""
    frame = int(frame_seconds * sr)
    hop = int(hop_seconds * sr)
    n = y.shape[-1]
    if n < frame:
        raise ValueError(
            f"audio shorter than one {frame_seconds * 1e3:.0f} ms intensity window"
            f" ({n} < {frame} samples)"
        )
    w = torch.from_numpy(get_window("hann", frame, periodic=True)).to(y.device, y.dtype)
    frames = y.unfold(-1, frame, hop) * w
    rms = torch.sqrt(torch.mean(frames * frames, dim=-1) + 1e-20)
    return 20.0 * torch.log10(rms / _P_REF)


def burg_lpc(frames: torch.Tensor, order: int = 10) -> torch.Tensor:
    """Burg's-method LPC coefficients per frame: (..., n) -> (..., order).

    Returns ``a[1..p]`` of ``A(z) = 1 + a1 z^-1 + ... + ap z^-p``, batched
    over leading axes.
    """
    n = frames.shape[-1]
    t = torch.arange(n, device=frames.device)
    i_idx = torch.arange(order, device=frames.device)
    f = b = frames
    a = torch.zeros(frames.shape[:-1] + (order,), dtype=frames.dtype, device=frames.device)
    for m in range(order):
        # textbook Burg stage m over the shrinking lag range, realized with
        # masks over the full length (paired as f[t], b[t-1] for t > m)
        b_prev = torch.cat([b[..., :1], b[..., :-1]], dim=-1)  # b[t-1]
        mask = (t >= m + 1).to(f.dtype)
        num = -2.0 * torch.sum(mask * f * b_prev, dim=-1)
        den = torch.sum(mask * (f * f + b_prev * b_prev), dim=-1) + 1e-12
        k = (num / den)[..., None]  # reflection coefficient
        # Kay/Marple updates, both stored at index t:
        #   f_{m+1}(t) = f_m(t) + k b_m(t-1);  b_{m+1}(t) = b_m(t-1) + k f_m(t)
        f, b = torch.where(mask > 0, f + k * b_prev, f), torch.where(mask > 0, b_prev + k * f, b)
        # Levinson step: a_i += k * a_{m-1-i} for i < m; a_m = k
        src = torch.clamp(m - 1 - i_idx, 0, order - 1)
        mirrored = torch.where(i_idx < m, a[..., src], torch.zeros((), dtype=a.dtype, device=a.device))
        a = a + k * mirrored
        a[..., m] = k[..., 0]
    return a


def _formants_from_lpc(a_row: np.ndarray, sr: float, *, max_formants: int = 5) -> np.ndarray:
    """LPC coefficients -> formant frequencies (host, numpy roots)."""
    poly = np.concatenate([[1.0], a_row])
    roots = np.roots(poly)
    roots = roots[np.imag(roots) > 0.01]
    freqs = np.angle(roots) * sr / (2 * np.pi)
    bws = -0.5 * sr / np.pi * np.log(np.abs(roots))
    keep = (freqs > 90) & (freqs < sr / 2 - 50) & (bws < 400)
    freqs = np.sort(freqs[keep])
    out = np.full(max_formants, np.nan)
    out[: min(len(freqs), max_formants)] = freqs[:max_formants]
    return out


def formant_tracks(
    y: np.ndarray,
    sr: int,
    *,
    frame_seconds: float = 0.025,
    hop_seconds: float = 0.01,
    order: int = 10,
    pre_emphasis: float = 0.97,
    device: str | torch.device = "cuda",
) -> tuple[np.ndarray, np.ndarray]:
    """(times, formants (n_frames, 5)) for one waveform: Burg on ``device``,
    the roots on the host."""
    y = np.asarray(y, np.float32)
    y = np.concatenate([y[:1], y[1:] - pre_emphasis * y[:-1]])
    frame = int(frame_seconds * sr)
    hop = int(hop_seconds * sr)
    if len(y) < frame:
        raise ValueError(
            f"audio shorter than one {frame_seconds * 1e3:.0f} ms analysis frame"
            f" ({len(y)} < {frame} samples)"
        )
    n_frames = 1 + (len(y) - frame) // hop
    # no analysis window: Burg models the segment directly and tapering
    # introduces spurious low-bandwidth poles
    frames = torch.from_numpy(y).to(device).unfold(-1, frame, hop)
    a = burg_lpc(frames, order).cpu().numpy()
    formants = np.stack([_formants_from_lpc(a[i], sr) for i in range(n_frames)])
    times = (np.arange(n_frames) * hop + frame / 2) / sr
    return times, formants


def _segments(mask: np.ndarray) -> list[tuple[int, int]]:
    segs, start = [], None
    for i, val in enumerate(mask):
        if val and start is None:
            start = i
        elif not val and start is not None:
            segs.append((start, i - 1))
            start = None
    if start is not None:
        segs.append((start, len(mask) - 1))
    return segs


def analyze_formants_and_silence(
    y: np.ndarray,
    sr: int,
    *,
    silence_threshold_db: float = 20.0,
    order: int = 10,
    device: str | torch.device = "cuda",
) -> dict[str, float]:
    """The reference's 10-feature prosodic dict
    (reference/ASV_dl_func.py:386-397), method-level Praat parity; the
    intensity and Burg run on ``device``."""
    y = np.asarray(y, np.float32)
    inten = intensity_db(torch.from_numpy(y).to(device), sr).cpu().numpy()
    silence_ratio = float(np.mean(inten < silence_threshold_db))

    times, formants = formant_tracks(y, sr, order=order, device=device)
    f1, f2 = formants[:, 0], formants[:, 1]
    vtl = np.where(f1 > 0, 35000.0 / (4.0 * f1), np.nan)

    def seg_stats(values):
        segs = _segments(~np.isnan(values))
        durations = [times[e] - times[s] for s, e in segs if e > s]
        return segs, durations

    f1_segs, f1_dur = seg_stats(f1)
    f2_segs, f2_dur = seg_stats(f2)
    vtl_segs, vtl_dur = seg_stats(vtl)

    def safe_mean(arr):
        return float(np.mean(arr)) if len(arr) else 0.0

    return {
        "silence_ratio": silence_ratio,
        "f1_total_segments": len(f1_segs),
        "f2_total_segments": len(f2_segs),
        "f1_avg_duration": safe_mean(f1_dur),
        "f2_avg_duration": safe_mean(f2_dur),
        "f1_total_duration": float(np.sum(f1_dur)),
        "f2_total_duration": float(np.sum(f2_dur)),
        "vtl_total_segments": len(vtl_segs),
        "vtl_avg_duration": safe_mean(vtl_dur),
        "vtl_total_duration": float(np.sum(vtl_dur)),
    }
