"""Mel filterbanks and log-mel spectrograms (librosa Slaney-parity, PyTorch).

Counterpart of the JAX package's ``frontend/mel.py``: librosa's
``melspectrogram(n_mels=64, fmax=sr/2)`` + ``power_to_db(ref=max)`` with the
Slaney mel scale (htk=False), Slaney area normalization and triangular
filters. The numpy builders (``hz_to_mel`` .. ``mel_filterbank``) and
``MelConfig`` are copies of the JAX package's, so both packages use
bitwise-equal constants and the same profiles.

``melspectrogram`` routes by the tensor's device: a CUDA tensor with
``method="matmul"`` (the default, the main path) goes through a
hand-written Hopper kernel, chosen by ``mel_route`` from the configuration
alone — ``ops/ct_mel.py::ct_mel`` (K3) where its factorization applies (the
parity profile), ``ops/wave_mel.py::wave_mel`` (K1) everywhere else; a CPU
tensor goes through the plain chain (frames @ DFT bases -> |.|^2 -> @
mel_fb.T). ``whisper_log_mel`` is Whisper's normalised log-mel on the same
route (K1 at Whisper's n_fft 400); ``whisper_log_mel_windows`` is the same
over whole clips, cut into 30-s windows (Voxtral's audio input).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from audioanalysisdetector_tpu_torch.frontend.db import power_to_db
from audioanalysisdetector_tpu_torch.frontend.stft import power_spectrogram


def hz_to_mel(frequencies: np.ndarray, *, htk: bool = False) -> np.ndarray:
    """Hz -> mel. Slaney formula by default (librosa ``htk=False``)."""
    frequencies = np.asanyarray(frequencies, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + frequencies / 700.0)
    f_sp = 200.0 / 3
    mels = frequencies / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    log_region = frequencies >= min_log_hz
    mels = np.where(
        log_region,
        min_log_mel + np.log(np.maximum(frequencies, min_log_hz) / min_log_hz) / logstep,
        mels,
    )
    return mels


def mel_to_hz(mels: np.ndarray, *, htk: bool = False) -> np.ndarray:
    mels = np.asanyarray(mels, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (mels / 2595.0) - 1.0)
    f_sp = 200.0 / 3
    freqs = f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    log_region = mels >= min_log_mel
    freqs = np.where(
        log_region, min_log_hz * np.exp(logstep * (mels - min_log_mel)), freqs
    )
    return freqs


def mel_frequencies(n_mels: int, fmin: float, fmax: float, *, htk: bool = False) -> np.ndarray:
    mels = np.linspace(hz_to_mel(fmin, htk=htk), hz_to_mel(fmax, htk=htk), n_mels)
    return mel_to_hz(mels, htk=htk)


def fft_frequencies(sr: float, n_fft: int) -> np.ndarray:
    return np.linspace(0.0, sr / 2.0, n_fft // 2 + 1)


@lru_cache(maxsize=None)
def mel_filterbank(
    sr: float,
    n_fft: int,
    n_mels: int = 128,
    fmin: float = 0.0,
    fmax: float | None = None,
    htk: bool = False,
    norm: str | None = "slaney",
) -> np.ndarray:
    """Triangular mel filterbank ``(n_mels, n_fft//2+1)`` (float64, host).

    The returned array is CACHED and read-only — in-place mutation by a
    caller would silently poison every later mel computation in-process.
    """
    fmax = sr / 2.0 if fmax is None else fmax
    fftfreqs = fft_frequencies(sr, n_fft)
    mel_f = mel_frequencies(n_mels + 2, fmin, fmax, htk=htk)
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    if norm == "slaney":
        enorm = 2.0 / (mel_f[2 : n_mels + 2] - mel_f[:n_mels])
        weights = weights * enorm[:, None]
    elif norm is not None:
        raise ValueError(f"unsupported mel norm {norm!r}")
    weights.flags.writeable = False
    return weights


@dataclass(frozen=True)
class MelConfig:
    """Static configuration of the mel frontend (hashable; keys the constant caches)."""

    sr: int = 16000
    n_fft: int = 2048
    hop_length: int = 512
    win_length: int | None = None
    window: str = "hann"
    center: bool = True
    pad_mode: str = "reflect"
    power: float = 2.0
    n_mels: int = 64
    fmin: float = 0.0
    fmax: float | None = None  # None -> sr / 2
    htk: bool = False
    norm: str | None = "slaney"
    method: str = "matmul"  # spectrum path: "matmul" (a mel kernel on CUDA) or "fft"

    def filterbank(self) -> np.ndarray:
        return mel_filterbank(
            float(self.sr),
            self.n_fft,
            self.n_mels,
            self.fmin,
            self.sr / 2.0 if self.fmax is None else self.fmax,
            self.htk,
            self.norm,
        )

    @classmethod
    def for_speech(cls, sr: int = 16000, *, n_mels: int = 64) -> "MelConfig":
        """Speech-standard resolution: 32 ms window / 16 ms hop at 16 kHz.

        The dataclass default (n_fft=2048 = 128 ms at 16 kHz) reproduces
        librosa's music-tuned default, which the reference inherited
        blindly (reference/ASV_dl_func.py:533) — kept as the parity
        contract. This profile (n_fft = 32 ms, hop = n_fft/2) is the
        conventional speech front-end, with an eighth of the DFT multiply-adds per
        utterance.
        """
        n_fft = int(round(0.032 * sr))
        # power-of-two window (exact for 16 kHz -> 512)
        n_fft = 1 << (n_fft - 1).bit_length()
        return cls(sr=sr, n_fft=n_fft, hop_length=n_fft // 2, n_mels=n_mels)

    @classmethod
    def for_profile(
        cls, profile: str, sr: int = 16000, *, n_mels: int = 64
    ) -> "MelConfig":
        """Resolve a named front-end profile — the ONE place train/score/
        serve/bench map ``"parity"``/``"speech"`` to a config, so the
        resolutions cannot silently diverge between entry points."""
        if profile == "speech":
            return cls.for_speech(sr, n_mels=n_mels)
        if profile == "parity":
            return cls(sr=sr, n_mels=n_mels)
        raise ValueError(f"unknown mel profile {profile!r} (parity|speech)")


@lru_cache(maxsize=None)
def _filterbank_on(cfg: MelConfig, device: torch.device) -> torch.Tensor:
    """``cfg.filterbank()`` as f32, uploaded once per device."""
    with torch.inference_mode(False):  # cached: a normal tensor, usable where autograd records
        return torch.from_numpy(cfg.filterbank().astype(np.float32)).to(device)


def mel_route(cfg: MelConfig, dtype: torch.dtype = torch.float32) -> str:
    """The kernel ``melspectrogram`` launches for a CUDA tensor of ``dtype``
    under ``cfg`` with ``method="matmul"``: ``"ct_mel"`` (K3) wherever
    ``ops.ct_mel.takes`` holds (its 64 x 32 factorization: the parity
    profile), else ``"wave_mel"`` (K1). A pure function of what the call
    can observe: no flag, no fallback."""
    from audioanalysisdetector_tpu_torch.ops.ct_mel import takes  # imports this module

    return "ct_mel" if takes(cfg, dtype) else "wave_mel"


def melspectrogram(y: torch.Tensor, cfg: MelConfig = MelConfig()) -> torch.Tensor:
    """Mel power spectrogram of ``(..., n)`` waveforms -> ``(..., n_mels, T)``.

    On a CUDA tensor ``method="matmul"`` launches the kernel that
    ``mel_route`` names. K1 takes every configuration the JAX chain
    computes (any ``power`` and ``n_mels``, float32 or bfloat16 waveforms);
    another dtype raises ``NotImplementedError`` there instead of quietly
    running the plain chain. ``method="fft"`` is ``torch.fft`` on any device.
    """
    if y.is_cuda and cfg.method == "matmul":
        # imported here: the kernel modules import this one for MelConfig
        if mel_route(cfg, y.dtype) == "ct_mel":
            from audioanalysisdetector_tpu_torch.ops.ct_mel import ct_mel_unpadded

            return ct_mel_unpadded(y, cfg).transpose(-1, -2)
        from audioanalysisdetector_tpu_torch.ops.wave_mel import wave_mel_unpadded

        return wave_mel_unpadded(y, cfg).transpose(-1, -2)
    S = power_spectrogram(
        y,
        n_fft=cfg.n_fft,
        hop_length=cfg.hop_length,
        win_length=cfg.win_length,
        window=cfg.window,
        center=cfg.center,
        pad_mode=cfg.pad_mode,
        power=cfg.power,
        method=cfg.method,
    )
    return _filterbank_on(cfg, S.device).to(S.dtype) @ S


def log_mel_spectrogram(
    y: torch.Tensor,
    cfg: MelConfig = MelConfig(),
    *,
    ref: float | str = "max",
    top_db: float | None = 80.0,
) -> torch.Tensor:
    """``power_to_db(melspectrogram(y), ref=max)`` — the reference's
    ``extract_mel_spectrogram`` contract, batched, with a per-utterance dB
    reference.

    Where ``ops.ct_mel.db_refusals`` names no reason (a CUDA float32 tensor
    at the parity profile, ``ref="max"``, ``top_db`` None or >= 0, clips up
    to ~5.9 s at 64 mels, no grad), K3 writes the dB itself in one launch
    (``ct_mel_db``), bitwise this chain, in ``melspectrogram``'s layout."""
    from audioanalysisdetector_tpu_torch.ops import ct_mel as k3  # imports this module

    if not k3.db_refusals(y, cfg, ref=ref, top_db=top_db):
        return k3.ct_mel_db(y, cfg, top_db=top_db).transpose(-1, -2)
    return power_to_db(melspectrogram(y, cfg), ref=ref, top_db=top_db, utt_axes=2)


def whisper_log_mel(y: torch.Tensor, cfg: MelConfig) -> torch.Tensor:
    """Whisper's log-mel of ``(..., n)`` waveforms -> ``(..., n_mels, T - 1)``,
    as transformers' ``WhisperFeatureExtractor`` computes it: the mel power
    (``melspectrogram``: K1 on the card at n_fft 400), its last frame
    dropped, ``log10(max(x, 1e-10))`` clipped from below at the
    utterance's own max - 8, then ``(x + 4) / 4``. That log10 and clip are
    ``power_to_db(ref=1, amin=1e-10, top_db=80) / 10``, the one home of the
    per-utterance dB policy. The max is each utterance's, as the published
    extractor takes it row by row (openai's package takes one over the
    batch, so a clip's features there depend on its batch)."""
    log_spec = power_to_db(melspectrogram(y, cfg)[..., :-1], ref=1.0, amin=1e-10, top_db=80.0, utt_axes=2) / 10.0
    return (log_spec + 4.0) / 4.0


def whisper_log_mel_windows(y: torch.Tensor, cfg: MelConfig, window_frames: int) -> torch.Tensor:
    """Whisper's log-mel of whole ``(B, n)`` clips cut into windows ->
    ``(B, W, n_mels, window_frames)``, as ``VoxtralProcessor`` prepares a
    clip padded to a multiple of 30 s: one ``whisper_log_mel`` over the
    whole clip (its reflect padding at the clip's two ends only, its max
    the whole clip's), then its ``n // hop`` frames cut into ``W``
    consecutive windows. On the card that is one K1 launch over the B
    clips."""
    mel = whisper_log_mel(y, cfg)
    b, m, t = mel.shape
    if t % window_frames:
        raise ValueError(f"{t} mel frames do not cut into windows of {window_frames}: pad the clips to a "
                         f"multiple of {window_frames * cfg.hop_length} samples")
    return mel.view(b, m, t // window_frames, window_frames).transpose(1, 2)
