"""Plain reference of the flagship fused system: waveform -> CQCC ->
standardise -> (BiLSTM classifier, GMM log-likelihood ratio) -> fused score.

Written from the published description (IzaP1k/AudioAnalysisDetector
``ASV_dl_func.py:442-481`` for the CQCC, ``:1132-1203`` for the GMMs,
``:1427-1445`` and ``:1448-1491`` for the classifier and the fusion), in
plain PyTorch, in the dtype of the waveform:

- CQT one octave at a time from the top: each bin a Hann-windowed complex
  exponential of ``ceil(Q sr_j / f)`` taps at the octave's rate, L1
  normalised, times ``sqrt`` of its length at the full rate, centred on
  frame ``m * hop_j`` of the zero-padded signal; between octaves a 63-tap
  Kaiser (beta 8) half-band FIR at stride 2;
- CQCC: magnitude to dB per utterance (``top_db`` 80), linear regrid of the
  geometric bins, ``log(x^2 + 1e-12)`` of the dB values, orthonormal DCT-II,
  the first ``n_ceps`` rows;
- frames standardised by a scaler fitted here on the scaler utterances;
- two stacked BiLSTMs, the readout at the last frame, dense to two logits,
  softmax; two diagonal GMMs' mean per-frame log-likelihood ratio over
  frames whose coefficients do not sum to 0; ``0.5 p + 0.5 sigmoid(LLR)``.

Nothing here imports the port.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from portbench.reference.common import hann, in_blocks, lstm


@lru_cache(maxsize=None)
def _octave_banks(sr: int, n_bins: int, bpo: int, fmin: float, filter_scale: float) -> tuple:
    """Per octave from the top: (kernels ``(2 nb, K)`` float64, K)."""
    q = filter_scale / (2.0 ** (1.0 / bpo) - 1.0)
    freqs = fmin * 2.0 ** (np.arange(n_bins) / bpo)
    out = []
    for j in range(math.ceil(n_bins / bpo)):
        hi = n_bins - j * bpo
        f = freqs[max(hi - bpo, 0):hi]
        sr_j = sr / 2**j
        taps = np.ceil(q * sr_j / f).astype(int)
        k = int(2 ** math.ceil(math.log2(taps.max())))
        bank = np.zeros((2 * len(f), k))
        for i, (fi, n) in enumerate(zip(f, taps)):
            t = np.arange(n) - (n - 1) / 2.0
            w = hann(n, periodic=False)
            amp = w / w.sum() * math.sqrt(q * sr / fi)
            start = (k - n) // 2
            bank[i, start:start + n] = amp * np.cos(2 * np.pi * fi * t / sr_j)
            bank[len(f) + i, start:start + n] = -amp * np.sin(2 * np.pi * fi * t / sr_j)
        out.append((bank, k))
    return tuple(out)


@lru_cache(maxsize=None)
def _halfband(taps: int) -> np.ndarray:
    from scipy.signal import firwin

    return firwin(taps, 0.475, window=("kaiser", 8.0))


def cqt(wav: torch.Tensor, cfg: dict) -> torch.Tensor:
    """``(B, n)`` -> ``(B, n_bins, T)`` magnitudes, lowest bin first."""
    dev, dt = wav.device, wav.dtype
    n_frames = 1 + wav.shape[-1] // cfg["hop_length"]
    banks = _octave_banks(cfg["sr"], cfg["n_bins"], cfg["bins_per_octave"], cfg["fmin"], cfg["filter_scale"])
    fir = torch.as_tensor(_halfband(cfg["decimation_taps"]), dtype=dt, device=dev)
    half = cfg["decimation_taps"] // 2
    cur = wav
    octaves = []
    for j, (bank, k) in enumerate(banks):
        hop = cfg["hop_length"] >> j
        n = cur.shape[-1]
        right = max((n_frames - 1) * hop + k - k // 2 - n, 0)
        x = torch.nn.functional.pad(cur, (k // 2, right))
        frames = x.unfold(-1, k, hop)[:, :n_frames]  # (B, T, K)
        resp = frames @ torch.as_tensor(bank.T, dtype=dt, device=dev)  # (B, T, 2 nb)
        nb = resp.shape[-1] // 2
        octaves.append(torch.sqrt(resp[..., :nb] ** 2 + resp[..., nb:] ** 2).transpose(1, 2))
        if j + 1 < len(banks):
            # y[t] = sum_i h[i] x[2t + i - half], zeros outside the signal
            xp = torch.nn.functional.pad(cur, (half, half))
            nxt = torch.zeros_like(cur[:, : n // 2])
            for i in range(len(fir)):
                nxt += fir[i] * xp[:, i : i + n - 1 : 2][:, : n // 2]
            cur = nxt
    return torch.cat(octaves[::-1], dim=1)


@lru_cache(maxsize=None)
def _regrid(n_bins: int, fmin: float, bpo: int) -> np.ndarray:
    """``(n_bins, n_bins)``: linear interpolation of the geometric grid's
    values at ``n_bins`` evenly spaced frequencies over the same span."""
    src = fmin * 2.0 ** (np.arange(n_bins) / bpo)
    dst = np.linspace(src[0], src[-1], n_bins)
    idx = np.clip(np.searchsorted(src, dst, side="right") - 1, 0, n_bins - 2)
    frac = (dst - src[idx]) / (src[idx + 1] - src[idx])
    w = np.zeros((n_bins, n_bins))
    w[np.arange(n_bins), idx] = 1.0 - frac
    w[np.arange(n_bins), idx + 1] = frac
    return w


@lru_cache(maxsize=None)
def _dct(n: int, n_out: int) -> np.ndarray:
    k = np.arange(n_out)[:, None]
    m = np.cos(np.pi * k * (2.0 * np.arange(n)[None, :] + 1.0) / (2.0 * n)) * math.sqrt(2.0 / n)
    m[0] *= math.sqrt(0.5)
    return m


def cqcc(wav: torch.Tensor, cfg: dict, *, with_interp: bool = False):
    """``(B, n)`` -> ``(B, T, n_ceps)`` time-major CQCC; with ``with_interp``
    also each utterance's smallest |regridded dB| (where the log quirk is
    steepest)."""
    mag = cqt(wav, cfg)
    power = mag * mag
    ref = torch.amax(power, dim=(1, 2), keepdim=True)
    amin = cfg["amin"] ** 2
    db = 10.0 * torch.log10(torch.clamp(power, min=amin)) - 10.0 * torch.log10(torch.clamp(ref, min=amin))
    db = torch.maximum(db, torch.amax(db, dim=(1, 2), keepdim=True) - cfg["top_db"])
    dev, dt = wav.device, wav.dtype
    interp = torch.as_tensor(_regrid(cfg["n_bins"], cfg["fmin"], cfg["bins_per_octave"]), dtype=dt, device=dev) @ db
    logp = torch.log(interp * interp + 1e-12)
    ceps = torch.as_tensor(_dct(cfg["n_bins"], cfg["n_ceps"]), dtype=dt, device=dev) @ logp  # (B, n_ceps, T)
    if with_interp:
        return ceps.transpose(1, 2), interp.abs().amin(dim=(1, 2))
    return ceps.transpose(1, 2)


def fit_scaler(frames: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Mean and population std over all frames ``(B, T, D)``; a zero std
    becomes 1."""
    flat = frames.reshape(-1, frames.shape[-1])
    mean = flat.mean(0)
    std = torch.sqrt(((flat - mean) ** 2).mean(0))
    return mean, torch.where(std == 0, torch.ones_like(std), std)


def _w(weights: dict, name: str, like: torch.Tensor) -> torch.Tensor:
    return weights[name].to(like.device, like.dtype)


def _dir(weights: dict, layer: str, suffix: str, like: torch.Tensor) -> list[torch.Tensor]:
    return [_w(weights, f"{layer}.lstm.{n}_l0{suffix}", like) for n in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")]


def bilstm_prob(x: torch.Tensor, weights: dict) -> torch.Tensor:
    """``(B, T, D)`` -> ``(B,)`` softmax probability of the spoof class."""
    h1 = torch.cat([lstm(x, *_dir(weights, "bilstm1", "", x)),
                    lstm(x, *_dir(weights, "bilstm1", "_reverse", x), reverse=True)], dim=-1)
    fwd = lstm(h1, *_dir(weights, "bilstm2", "", h1))[:, -1]
    bwd = lstm(h1, *_dir(weights, "bilstm2", "_reverse", h1), reverse=True, steps=1)[:, -1]
    logits = torch.cat([fwd, bwd], dim=-1) @ _w(weights, "fc.weight", fwd).T + _w(weights, "fc.bias", fwd)
    return torch.softmax(logits, dim=-1)[:, 1]


def gmm_frame_ll(x: torch.Tensor, weights: dict, name: str) -> torch.Tensor:
    """Per-frame log-likelihood ``(B, T)`` of the diagonal GMM ``name``."""
    w, mu, var = (_w(weights, f"{name}.{k}", x) for k in ("weights", "means", "variances"))
    d = x.shape[-1]
    quad = (((x[..., None, :] - mu) ** 2) / var).sum(-1)  # (B, T, K)
    logp = torch.log(w) - 0.5 * (d * math.log(2 * math.pi) + torch.log(var).sum(-1) + quad)
    return torch.logsumexp(logp, dim=-1)


def fused(x: torch.Tensor, weights: dict) -> torch.Tensor:
    """Standardised ``(B, T, D)`` frames -> ``(B,)`` fused spoof scores."""
    p = bilstm_prob(x, weights)
    mask = (x.sum(-1) != 0).to(x.dtype)
    diff = gmm_frame_ll(x, weights, "gmm_spoof") - gmm_frame_ll(x, weights, "gmm_genuine")
    llr = (diff * mask).sum(-1) / mask.sum(-1).clamp_min(1.0)
    score = 0.5 * p + 0.5 * torch.sigmoid(llr)
    return torch.where(mask.sum(-1) == 0, torch.full_like(score, 0.5), score)


def scaler(cfg: dict, scaler_wav: torch.Tensor, *, dtype: torch.dtype = torch.float64,
           rows: int = 256) -> tuple[torch.Tensor, torch.Tensor]:
    """The scaler fitted on the CQCC of ``scaler_wav``."""
    return fit_scaler(in_blocks(lambda x: cqcc(x.to(dtype), cfg), scaler_wav, rows))


def evaluate(cfg: dict, weights: dict, wav: torch.Tensor, *, aux: dict, dtype: torch.dtype = torch.float64,
             rows: int = 2048) -> tuple[torch.Tensor, torch.Tensor]:
    """``(B, n)`` waveforms -> (``(B,)`` fused scores in ``dtype``, ``(B,)``
    which utterances a score is compared for). The scaler is fitted on
    ``aux["scaler_wav"]`` in the same dtype.

    The configuration's semantics hold two points where an answer jumps
    with the last bit of its input, and an utterance near either is left
    out of the comparison: a regridded dB value within
    ``cfg["compare"]["min_abs_interp_db"]`` of 0, where the slope of
    ``log(x^2 + 1e-12)`` reaches 1/x; and a frame whose standardised
    coefficients sum to within ``cfg["compare"]["min_abs_frame_sum"]`` of 0,
    which the padding rule counts or drops on the sign of a rounding."""
    mean, std = scaler(cfg, aux["scaler_wav"], dtype=dtype)
    lim = cfg["compare"]

    def block(x):
        ceps, small = cqcc(x.to(dtype), cfg, with_interp=True)
        z = (ceps - mean) / std
        ok = (small >= lim["min_abs_interp_db"]) & (z.sum(-1).abs().amin(-1) >= lim["min_abs_frame_sum"])
        return torch.stack([fused(z, weights), ok.to(z.dtype)], dim=-1)

    out = in_blocks(block, wav, rows)
    return out[:, 0], out[:, 1] > 0


def scores(cfg: dict, weights: dict, wav: torch.Tensor, *, aux: dict, dtype: torch.dtype = torch.float64,
           rows: int = 2048) -> torch.Tensor:
    """``(B, n)`` waveforms -> ``(B,)`` fused scores in ``dtype``."""
    return evaluate(cfg, weights, wav, aux=aux, dtype=dtype, rows=rows)[0]
