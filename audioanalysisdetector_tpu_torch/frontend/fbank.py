"""Kaldi-compatible log-mel filterbank, the front end of w2v-BERT 2.0 (PyTorch).

What Seamless's feature extractor (Seamless Communication, arXiv:2312.05187;
transformers' ``SeamlessM4TFeatureExtractor``, which reproduces
``torchaudio.compliance.kaldi.fbank``) computes from 16-kHz samples, batched:

1. the samples scaled by 2^15 (Kaldi reads 16-bit integers);
2. frames of 400 samples at hop 160, not centred: ``1 + (n - 400) // 160``;
3. each frame's mean removed;
4. pre-emphasis inside the frame: ``x[1:] -= 0.97 x[:-1]``, ``x[0] *= 0.03``;
5. the Povey window, a symmetric Hann window to the power 0.85;
6. zero-padded to 512 and ``|rfft|^2``;
7. 80 triangular filters, triangular in Kaldi's mel scale
   (``1127 ln(1 + f / 700)``) between 20 and 8000 Hz, not normalised;
8. floored at float32's epsilon and the natural log taken;
9. each bin normalised over the utterance's frames:
   ``(x - mean) / sqrt(var + 1e-7)``, the variance unbiased;
10. an odd last frame dropped and frame pairs stacked: ``(T, 160)``, frame
    ``2t``'s 80 bins then frame ``2t + 1``'s.

The steps run in float64, as the published extractor computes its
spectrogram (numpy, float64), and the features come back in the
waveform's dtype. In float32 the FFT's rounding is relative to a frame's
whole energy, so a weak bin beside a tone keeps little of its precision,
and step 9 divides it by the bin's spread over the frames, which can be small
for steady audio: at the 16-s scorer's shapes the float32 filterbank moved
the features by up to 1.4e-3 and the logits by ~1e-4, four times what the
Conformer's float32 arithmetic adds.

Departure: the published extractor, given one utterance of an odd frame
count, pads it with a zero frame to an even count (``pad_to_multiple_of=2``)
instead of dropping the frame. At the scorer's 256,000 samples the count is
1,598, even, and the two agree.

The window and the filter matrix are host-built float64 constants, uploaded
once per device, outside ``inference_mode`` so that a grad-mode call after
an inference call still has its backward.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch


@dataclass(frozen=True)
class FbankConfig:
    sr: int = 16000
    frame_length: int = 400
    hop_length: int = 160
    n_fft: int = 512
    n_mels: int = 80
    fmin: float = 20.0
    fmax: float = 8000.0
    preemphasis: float = 0.97
    window_power: float = 0.85  # the Povey window: Hann ** 0.85
    sample_scale: float = 32768.0  # 2 ** 15
    mel_floor: float = 1.1920928955078125e-07  # float32's epsilon
    norm_eps: float = 1e-7
    stride: int = 2  # frames stacked into one feature row

    @property
    def feature_dim(self) -> int:
        return self.n_mels * self.stride


def kaldi_mel(f: np.ndarray) -> np.ndarray:
    return 1127.0 * np.log(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


@lru_cache(maxsize=None)
def kaldi_filterbank(cfg: FbankConfig) -> np.ndarray:
    """``(n_mels, n_fft // 2 + 1)`` float64, read-only: each filter a
    triangle in Kaldi mel between its neighbours' centres, over the FFT
    bins' frequencies taken to mel."""
    centres = np.linspace(kaldi_mel(cfg.fmin), kaldi_mel(cfg.fmax), cfg.n_mels + 2)
    bins = kaldi_mel(np.arange(cfg.n_fft // 2 + 1) * cfg.sr / cfg.n_fft)
    rise = (bins[None, :] - centres[:-2, None]) / (centres[1:-1] - centres[:-2])[:, None]
    fall = (centres[2:, None] - bins[None, :]) / (centres[2:] - centres[1:-1])[:, None]
    w = np.maximum(0.0, np.minimum(rise, fall))
    w.flags.writeable = False
    return w


@lru_cache(maxsize=None)
def povey_window(cfg: FbankConfig) -> np.ndarray:
    n = cfg.frame_length
    w = (0.5 - 0.5 * np.cos(2.0 * math.pi * np.arange(n) / (n - 1))) ** cfg.window_power
    w.flags.writeable = False
    return w


@lru_cache(maxsize=None)
def _operands_on(cfg: FbankConfig, device: torch.device, dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """The window and the filter matrix, transposed, on ``device``."""
    with torch.inference_mode(False):  # cached: a normal tensor, usable where autograd records
        return (torch.tensor(povey_window(cfg), device=device, dtype=dtype),
                torch.tensor(kaldi_filterbank(cfg).T, device=device, dtype=dtype))


def windowed_frames(wav: torch.Tensor, cfg: FbankConfig, window: torch.Tensor) -> torch.Tensor:
    """Steps 1-5: ``(B, n)`` -> ``(B, F, frame_length)`` scaled frames,
    each less its mean, pre-emphasised and windowed."""
    frames = (wav * cfg.sample_scale).unfold(-1, cfg.frame_length, cfg.hop_length)
    frames = frames - frames.mean(-1, keepdim=True)
    frames = torch.cat([frames[..., :1] * (1.0 - cfg.preemphasis),
                        frames[..., 1:] - cfg.preemphasis * frames[..., :-1]], dim=-1)
    return frames * window


def kaldi_fbank(wav: torch.Tensor, cfg: FbankConfig = FbankConfig()) -> torch.Tensor:
    """``(B, n)`` waveforms in [-1, 1] -> ``(B, T, n_mels * stride)``
    normalised, stacked log-mel features (module docstring), computed in
    float64 and returned in the waveform's dtype."""
    window, mel_t = _operands_on(cfg, wav.device, torch.float64)
    spec = torch.fft.rfft(windowed_frames(wav.double(), cfg, window), n=cfg.n_fft)
    power = spec.real.square() + spec.imag.square()  # (B, F, n_fft // 2 + 1)
    logmel = torch.log(torch.clamp(power @ mel_t, min=cfg.mel_floor))  # (B, F, n_mels)
    mean = logmel.mean(1, keepdim=True)
    normed = (logmel - mean) / torch.sqrt(logmel.var(1, keepdim=True) + cfg.norm_eps)
    b, f, m = normed.shape
    t = f // cfg.stride
    return normed[:, :t * cfg.stride].reshape(b, t, cfg.stride * m).to(wav.dtype)
