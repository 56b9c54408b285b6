"""Batched augmentation: noise, time shift, phase-vocoder pitch shift, SpecAugment (PyTorch).

Counterpart of the JAX package's ``data/augment.py`` (BASELINE config #3).
The reference augments on the host inside the extractors (``augment_audio``,
reference/ASV_dl_func.py:78-93: pitch shift via librosa's phase vocoder,
additive Gaussian noise) and expands the dataset row-wise
(reference/ASV_dl_func.py:96-127, ``data/balance.py::add_data_augmentation``).
Here every augmentation is a batched function on the waveform's device.

Where the JAX package takes a PRNG ``key`` this module takes a
``torch.Generator`` on the tensor's device, which only draws: the row
shifts, the noise, the mask starts and widths. Each transform is a function
of those draws (``shift_rows``, ``augment_rows``, ``mask_spans``), so the
JAX package's draws can be fed to it.

Note on defaults: the reference's noise default ``factor=1.022`` drowns the
signal (documented bug, SURVEY.md quirks); notebook usage passes 0.005,
which is the default here. The reference's pitch default ``n_steps=0.005``
(a 1/200 semitone) is preserved as the API default.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from audioanalysisdetector_tpu_torch.frontend.istft import istft
from audioanalysisdetector_tpu_torch.frontend.stft import stft_realimag


def add_noise(wav: torch.Tensor, generator: torch.Generator, *, factor: float = 0.005) -> torch.Tensor:
    """``wav + factor * N(0, 1)`` — the reference's "noise" mode."""
    return wav + factor * torch.randn(wav.shape, generator=generator, dtype=wav.dtype, device=wav.device)


def shift_rows(wav: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """Circular shift of each utterance of ``(..., n)`` by its entry of
    ``shifts`` (shape ``wav.shape[:-1]``; positive moves samples later)."""
    n = wav.shape[-1]
    flat = wav.reshape(-1, n)
    idx = (torch.arange(n, device=wav.device)[None, :] - shifts.reshape(-1, 1).to(wav.device)) % n
    return torch.take_along_dim(flat, idx, dim=-1).reshape(wav.shape)


def time_shift(wav: torch.Tensor, generator: torch.Generator, *, max_frac: float = 0.1) -> torch.Tensor:
    """Random circular shift per utterance, up to ``max_frac`` of the length."""
    max_shift = max(int(wav.shape[-1] * max_frac), 1)
    shifts = torch.randint(-max_shift, max_shift + 1, wav.shape[:-1], generator=generator, device=wav.device)
    return shift_rows(wav, shifts)


@lru_cache(maxsize=None)
def _sinc_kernel(taps: int = 16) -> np.ndarray:
    # Hann-windowed sinc interpolator offsets (host constant)
    return np.arange(-taps // 2 + 1, taps // 2 + 1).astype(np.float32)


def resample_to(y: torch.Tensor, n_out: int, *, taps: int = 16) -> torch.Tensor:
    """Windowed-sinc fractional resample of ``(..., n_in)`` to ``n_out``.

    The taps are summed one at a time (``n_out`` gathered samples each), so
    no ``(..., n_out, taps)`` product is ever held."""
    n_in = y.shape[-1]
    rate = n_in / n_out
    pos = torch.arange(n_out, dtype=torch.float32, device=y.device) * rate  # source positions
    base = torch.floor(pos).to(torch.int64)
    frac = pos - base
    offs = torch.from_numpy(_sinc_kernel(taps)).to(y.device)  # (taps,)
    idx = torch.clamp(base[:, None] + offs[None, :].to(torch.int64), 0, n_in - 1)
    t = offs[None, :] - frac[:, None]  # (n_out, taps)
    win = 0.5 + 0.5 * torch.cos(torch.pi * torch.clamp(t / (taps // 2), -1.0, 1.0))
    weights = torch.sinc(t) * win
    weights = (weights / torch.sum(weights, dim=-1, keepdim=True)).to(y.dtype)
    out = y[..., idx[:, 0]] * weights[:, 0]
    for j in range(1, taps):
        out = out + y[..., idx[:, j]] * weights[:, j]
    return out


def _phase_vocoder(
    re: torch.Tensor, im: torch.Tensor, rate: float, hop_length: int, n_fft: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """librosa-style phase vocoder on (..., F, T) re/im -> stretched (..., F, T2)."""
    T = re.shape[-1]
    T2 = int(np.ceil(T / rate))
    time_steps = np.arange(T2) * rate  # fractional source frames
    lo = np.minimum(np.floor(time_steps).astype(np.int32), T - 1)
    hi = np.minimum(lo + 1, T - 1)
    dev = re.device
    alpha = torch.from_numpy((time_steps - lo).astype(np.float32)).to(dev)
    lo, hi = torch.from_numpy(lo).to(dev, torch.int64), torch.from_numpy(hi).to(dev, torch.int64)

    F = re.shape[-2]
    # expected phase advance per hop
    omega = torch.from_numpy((2.0 * np.pi * hop_length * np.arange(F) / n_fft).astype(np.float32)).to(dev)[:, None]

    mag = torch.sqrt(re * re + im * im)
    phase = torch.atan2(im, re)
    mag_i = (1.0 - alpha) * mag[..., lo] + alpha * mag[..., hi]  # (..., F, T2)

    # instantaneous phase increment between consecutive source frames
    dphase = phase[..., 1:] - phase[..., :-1] - omega
    dphase = dphase - 2.0 * np.pi * torch.round(dphase / (2.0 * np.pi))
    # inc_full[..., t] = true advance from frame t-1 to t
    inc_full = torch.cat([torch.zeros_like(phase[..., :1]), dphase + omega], dim=-1)
    inc = inc_full[..., hi]  # the advance at each output step's interpolation point
    acc = phase[..., :1] + torch.cumsum(inc, dim=-1) - inc[..., :1]
    return mag_i * torch.cos(acc), mag_i * torch.sin(acc)


def time_stretch(
    wav: torch.Tensor, rate: float, *, n_fft: int = 2048, hop_length: int = 512
) -> torch.Tensor:
    """Phase-vocoder time stretch: length n -> round(n / rate), re/im
    carried separately (no complex dtype)."""
    re, im = stft_realimag(wav, n_fft=n_fft, hop_length=hop_length)
    re2, im2 = _phase_vocoder(re, im, rate, hop_length, n_fft)
    del re, im
    n_out = int(round(wav.shape[-1] / rate))
    return istft(re2, im2, n_fft=n_fft, hop_length=hop_length, length=n_out)


def pitch_shift(
    wav: torch.Tensor,
    *,
    n_steps: float = 0.005,
    bins_per_octave: int = 12,
    n_fft: int = 2048,
    hop_length: int = 512,
) -> torch.Tensor:
    """librosa ``pitch_shift`` semantics: stretch by ``2**(-n_steps/B)`` then
    resample back to the original length (same shape out). Deterministic:
    the randomness of the reference's policy is in *which* augmentation a
    row gets."""
    rate = 2.0 ** (-n_steps / bins_per_octave)
    if abs(rate - 1.0) < 1e-9:
        return wav
    stretched = time_stretch(wav, rate, n_fft=n_fft, hop_length=hop_length)
    return resample_to(stretched, wav.shape[-1])


def mask_spans(
    x: torch.Tensor, starts: torch.Tensor, widths: torch.Tensor, *, axis: int, mask_value: float = 0.0
) -> torch.Tensor:
    """Set ``[start, start + width)`` of each ``(B, F, T)`` map along
    ``axis`` (-2: frequency, -1: time) to ``mask_value``; ``starts`` and
    ``widths`` are ``(B,)``."""
    coords = torch.arange(x.shape[axis], device=x.device)
    starts, widths = starts.to(x.device)[:, None], widths.to(x.device)[:, None]
    m = (coords[None, :] >= starts) & (coords[None, :] < starts + widths)
    m = m[:, :, None] if axis == -2 else m[:, None, :]
    return torch.where(m, torch.tensor(mask_value, dtype=x.dtype, device=x.device), x)


def spec_augment(
    feat: torch.Tensor,
    generator: torch.Generator,
    *,
    n_time_masks: int = 2,
    n_freq_masks: int = 2,
    max_time_width: int = 8,
    max_freq_width: int = 8,
    mask_value: float = 0.0,
) -> torch.Tensor:
    """SpecAugment time/frequency masking on ``(..., F, T)`` feature maps:
    per map and mask a width uniform in ``[0, max_width]`` and a start
    uniform in ``[0, max(len - width, 1))``, frequency masks first."""
    flat = feat.reshape((-1,) + feat.shape[-2:])
    B = flat.shape[0]
    for axis, n_masks, max_width in ((-2, n_freq_masks, max_freq_width), (-1, n_time_masks, max_time_width)):
        for _ in range(n_masks):
            widths = torch.randint(0, max_width + 1, (B,), generator=generator, device=feat.device)
            high = torch.clamp(flat.shape[axis] - widths, min=1)
            u = torch.rand((B,), generator=generator, device=feat.device)
            starts = torch.minimum((u * high).to(torch.int64), high - 1)
            flat = mask_spans(flat, starts, widths, axis=axis, mask_value=mask_value)
    return flat.reshape(feat.shape)


# --------------------------------------------------------- policy application

AUG_NONE, AUG_PITCH, AUG_NOISE = 0, 1, 2
AUG_CODES = {"": AUG_NONE, None: AUG_NONE, "change pitch": AUG_PITCH, "noise": AUG_NOISE}


def augment_rows(
    wav: torch.Tensor,
    aug_codes: torch.Tensor,
    noise: torch.Tensor,
    *,
    noise_factor: float = 0.005,
    pitch_steps: float = 0.005,
) -> torch.Tensor:
    """``apply_augmentations`` given its noise draw ``noise`` (``wav``'s
    shape): AUG_NOISE rows get ``wav + noise_factor * noise``, AUG_PITCH
    rows ``pitch_shift``, AUG_NONE rows stay as they are. Only the pitch
    rows go through the phase vocoder (it is per row)."""
    code = aug_codes.to(wav.device).reshape((-1,) + (1,) * (wav.ndim - 1))
    out = torch.where(code == AUG_NOISE, wav + noise_factor * noise, wav)
    pitch = (aug_codes == AUG_PITCH).reshape(-1).to(wav.device)
    if bool(pitch.any()):
        flat = out.reshape(-1, wav.shape[-1]).clone()
        flat[pitch] = pitch_shift(flat[pitch], n_steps=pitch_steps)
        out = flat.reshape(wav.shape)
    return out


def apply_augmentations(
    wav: torch.Tensor,
    aug_codes: torch.Tensor,
    generator: torch.Generator,
    *,
    noise_factor: float = 0.005,
    pitch_steps: float = 0.005,
) -> torch.Tensor:
    """Apply the reference's per-row augmentation selection on the batch's device.

    ``aug_codes`` (B,) int — AUG_NONE / AUG_PITCH / AUG_NOISE per row
    (the ``augmentationType`` column, reference/ASV_dl_func.py:111-118).
    The noise is drawn for the whole batch from ``generator``.
    """
    noise = torch.randn(wav.shape, generator=generator, dtype=wav.dtype, device=wav.device)
    return augment_rows(wav, aug_codes, noise, noise_factor=noise_factor, pitch_steps=pitch_steps)


def make_augmented_feature_fn(feature_fn, **aug_kwargs):
    """Wrap a frontend extractor into (wav, aug_codes, generator) -> features."""

    def fn(wav, aug_codes, generator):
        return feature_fn(apply_augmentations(wav, aug_codes, generator, **aug_kwargs))

    return fn
