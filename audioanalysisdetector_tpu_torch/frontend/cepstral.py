"""LFCC and GFCC — spafe-style cepstral pipelines, batched (PyTorch).

Counterpart of the JAX package's ``frontend/cepstral.py``. The reference
computes LFCC via ``spafe.features.lfcc.lfcc(sig=y_int16, fs, num_ceps=13)``
after an int16 scaling quirk (reference/ASV_dl_func.py:434-435) and GFCC via
``spafe.features.gfcc.gfcc(sig=y, fs, num_ceps=13, nfilts=40)``
(reference/ASV_dl_func.py:495). spafe's pipeline:

  pre-emphasis (0.97) -> 25 ms / 10 ms hamming frames (zero-padded to a whole
  number of frames, no centering) -> power spectrum ``|rfft|^2 / nfft``
  (nfft=512) -> triangular filterbank (linear- or ERB/gammatone-spaced) ->
  log10 -> orthonormal DCT-II over the filter axis -> first ``num_ceps``.

The output is time-major ``(..., n_frames, num_ceps)``, spafe's layout. The
frames are a strided view (``unfold``) of the zero-padded signal, the
spectrum two GEMMs against host-built cos/sin bases, then the filterbank and
DCT GEMMs. The numpy constructors (``erb_space``, the filterbanks, the DFT
bases) are copies of the JAX package's.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from audioanalysisdetector_tpu_torch.frontend.dct import dct_ii_matrix
from audioanalysisdetector_tpu_torch.frontend.windows import get_window

_EPS = 2.220446049250313e-16  # np.finfo(float).eps — spafe's log floor


def int16_quirk(y: torch.Tensor) -> torch.Tensor:
    """The reference's ``(y * 32767).astype(np.int16)`` scaling
    (reference/ASV_dl_func.py:434): truncation toward zero + int16 wrap-free
    clip, returned as float."""
    return torch.clamp(torch.trunc(y * 32767.0), -32768.0, 32767.0)


def pre_emphasis(y: torch.Tensor, coeff: float = 0.97) -> torch.Tensor:
    """y[n] - coeff * y[n-1], first sample kept (spafe convention)."""
    return torch.cat([y[..., :1], y[..., 1:] - coeff * y[..., :-1]], dim=-1)


def _spafe_frame_count(n: int, frame_len: int, hop: int) -> int:
    if n < frame_len:
        return 1
    return 1 + int(np.ceil((n - frame_len) / hop))


def _frames_uncentered(y: torch.Tensor, frame_len: int, hop: int) -> torch.Tensor:
    """spafe framing: zero-pad the tail so frames tile the signal exactly."""
    n = y.shape[-1]
    n_frames = _spafe_frame_count(n, frame_len, hop)
    y = F.pad(y, (0, frame_len + (n_frames - 1) * hop - n))
    return y.unfold(-1, frame_len, hop)


def erb_space(low_freq: float, high_freq: float, n: int) -> np.ndarray:
    """Glasberg & Moore ERB-rate spaced center frequencies (ascending)."""
    ear_q, min_bw = 9.26449, 24.7
    i = np.arange(1, n + 1)
    cf = -(ear_q * min_bw) + np.exp(
        i * (-np.log(high_freq + ear_q * min_bw) + np.log(low_freq + ear_q * min_bw)) / n
    ) * (high_freq + ear_q * min_bw)
    return cf[::-1].copy()


@lru_cache(maxsize=None)
def linear_filterbank(nfilts: int, nfft: int, fs: float, low: float = 0.0, high: float | None = None) -> np.ndarray:
    """Triangular filters with linearly spaced centers, ``(nfilts, nfft//2+1)``."""
    high = fs / 2 if high is None else high
    freqs = np.linspace(0, fs / 2, nfft // 2 + 1)
    centers = np.linspace(low, high, nfilts + 2)
    fb = np.zeros((nfilts, len(freqs)))
    for i in range(nfilts):
        lo, c, hi = centers[i], centers[i + 1], centers[i + 2]
        fb[i] = np.clip(np.minimum((freqs - lo) / (c - lo), (hi - freqs) / (hi - c)), 0, None)
    return fb


@lru_cache(maxsize=None)
def gammatone_filterbank(nfilts: int, nfft: int, fs: float, low: float = 0.0, high: float | None = None, order: int = 4) -> np.ndarray:
    """Frequency-domain gammatone magnitude responses, ``(nfilts, nfft//2+1)``.

    Patterson–Holdsworth: ``|H(f)| = [1 + ((f - fc)/b)^2]^(-order/2)`` with
    ``b = 1.019 * ERB(fc)``; each filter peak-normalized to 1.
    """
    high = fs / 2 if high is None else high
    freqs = np.linspace(0, fs / 2, nfft // 2 + 1)
    cfs = erb_space(max(low, 26.0), high, nfilts)
    fb = np.zeros((nfilts, len(freqs)))
    for i, fc in enumerate(cfs):
        erb = 24.7 * (4.37 * fc / 1000.0 + 1.0)
        b = 1.019 * erb
        fb[i] = (1.0 + ((freqs - fc) / b) ** 2) ** (-order / 2.0)
    return fb


@lru_cache(maxsize=None)
def _dft_bases(nfft: int, frame_len: int) -> tuple[np.ndarray, np.ndarray]:
    """The first ``frame_len`` rows of the nfft-point real-DFT cos/sin bases
    (a frame zero-padded to nfft), f32 ``(frame_len, nfft // 2 + 1)``."""
    n = np.arange(nfft)[:, None]
    k = np.arange(nfft // 2 + 1)[None, :]
    ang = 2.0 * np.pi * n * k / nfft
    cos_b = np.cos(ang)[:frame_len].astype(np.float32)
    sin_b = (-np.sin(ang))[:frame_len].astype(np.float32)
    return cos_b, sin_b


@dataclass(frozen=True)
class CepstralConfig:
    fs: int = 16000
    num_ceps: int = 13
    nfilts: int = 24
    nfft: int = 512
    win_len: float = 0.025
    win_hop: float = 0.010
    window: str = "hamming"
    pre_emph: float = 0.97
    low_freq: float = 0.0
    high_freq: float | None = None
    fb_kind: str = "linear"  # "linear" (LFCC) or "gammatone" (GFCC)

    @property
    def frame_len(self) -> int:
        return int(self.win_len * self.fs)

    @property
    def hop(self) -> int:
        return int(self.win_hop * self.fs)

    def filterbank(self) -> np.ndarray:
        make = linear_filterbank if self.fb_kind == "linear" else gammatone_filterbank
        return make(self.nfilts, self.nfft, float(self.fs), self.low_freq, self.high_freq)

    def n_frames(self, n_samples: int) -> int:
        return _spafe_frame_count(n_samples, self.frame_len, self.hop)


@lru_cache(maxsize=None)
def _operands_on(cfg: CepstralConfig, device: torch.device, dtype: torch.dtype) -> tuple[torch.Tensor, ...]:
    """Window, DFT bases, filterbank^T and DCT^T of ``cfg``, uploaded once per device."""
    w = get_window(cfg.window, cfg.frame_len, periodic=False)
    cos_b, sin_b = _dft_bases(cfg.nfft, cfg.frame_len)
    fb_t = cfg.filterbank().T
    dct_t = dct_ii_matrix(cfg.nfilts, cfg.num_ceps).T
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device, dtype) for a in (w, cos_b, sin_b, fb_t, dct_t))


def _cepstra(y: torch.Tensor, cfg: CepstralConfig) -> torch.Tensor:
    w, cos_b, sin_b, fb_t, dct_t = _operands_on(cfg, y.device, y.dtype)
    frames = _frames_uncentered(pre_emphasis(y, cfg.pre_emph), cfg.frame_len, cfg.hop) * w
    re = frames @ cos_b
    im = frames @ sin_b
    power = (re * re + im * im) / cfg.nfft
    logfeat = torch.log10(torch.clamp(power @ fb_t, min=_EPS))
    return logfeat @ dct_t  # (..., n_frames, num_ceps) — spafe's time-major layout


def lfcc(y: torch.Tensor, cfg: CepstralConfig | None = None, *, apply_int16_quirk: bool = True) -> torch.Tensor:
    """LFCC of ``(..., n)`` waveforms -> ``(..., n_frames, num_ceps)``.

    Defaults mirror ``extract_lfcc`` (reference/ASV_dl_func.py:423-439)
    including the int16 pre-scaling quirk.
    """
    cfg = cfg or CepstralConfig(fb_kind="linear")
    if apply_int16_quirk:
        y = int16_quirk(y)
    return _cepstra(y, cfg)


def gfcc(y: torch.Tensor, cfg: CepstralConfig | None = None) -> torch.Tensor:
    """GFCC of ``(..., n)`` waveforms -> ``(..., n_frames, num_ceps)``.

    Defaults mirror ``extract_gtcc`` (reference/ASV_dl_func.py:484-499):
    40 gammatone filters, 13 ceps, no int16 scaling.
    """
    cfg = cfg or CepstralConfig(nfilts=40, fb_kind="gammatone")
    return _cepstra(y, cfg)
