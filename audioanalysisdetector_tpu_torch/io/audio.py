"""Host-side audio decode + duration probing (L0).

A copy of the JAX package's ``io/audio.py``, so that the port decodes
without importing that package (which imports jax); the two are held
bitwise equal by ``tests/test_torch_io_score.py``.

The reference reaches audio through ``librosa.load`` (decode + resample to
float32 mono) and ``soundfile.info`` (duration probe without decoding) —
reference/ASV_dl_func.py:406, :195. Neither library exists in this
environment; WAV decode is implemented directly on the stdlib ``wave``
reader (integer PCM 8/16/24/32-bit; stdlib ``wave`` rejects IEEE-float
WAVs before we see them — those decode via the native C++ loader or the
optional ``soundfile`` import). FLAC — the container the reference's
ASVspoof corpora actually use — decodes through the in-repo codec
(``io/flac.py`` fallback, ``native/flacdec.cpp`` hot path).

Decode stays on the host by design (SURVEY.md §2.5); everything downstream
of the float32 waveform batch is on-device.
"""

from __future__ import annotations

import os
import wave
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class AudioInfo:
    frames: int
    samplerate: int
    channels: int

    @property
    def duration(self) -> float:
        return self.frames / self.samplerate


def audio_info(path: str) -> AudioInfo:
    """Duration probe without full decode (``soundfile.info`` role)."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".wav":
        try:
            with wave.open(path, "rb") as w:
                return AudioInfo(w.getnframes(), w.getframerate(), w.getnchannels())
        except wave.Error:
            # stdlib wave only admits integer PCM; IEEE-float / extensible
            # WAVs fall through to soundfile when it is available
            sf = _soundfile()
            if sf is None:
                raise
            info = sf.info(path)
            return AudioInfo(int(info.frames), int(info.samplerate), int(info.channels))
    if ext == ".flac":
        from audioanalysisdetector_tpu_torch.io.flac import flac_stream_info

        si = flac_stream_info(path)
        return AudioInfo(si.total_samples, si.sample_rate, si.channels)
    sf = _soundfile()
    if sf is not None:
        info = sf.info(path)
        return AudioInfo(int(info.frames), int(info.samplerate), int(info.channels))
    raise RuntimeError(f"cannot probe {path!r}: unsupported container")


def _soundfile():
    try:
        import soundfile

        return soundfile
    except ImportError:
        return None


def _decode_wav(path: str) -> tuple[np.ndarray, int]:
    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        channels = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(w.getnframes())
    if width == 2:
        y = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        # stdlib wave only admits integer PCM (format 1), so width 4 is int32
        y = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 1:
        y = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    elif width == 3:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        i32 = (
            b[:, 0].astype(np.int32)
            | (b[:, 1].astype(np.int32) << 8)
            | (b[:, 2].astype(np.int32) << 16)
        )
        i32 = np.where(i32 & 0x800000, i32 - 0x1000000, i32)
        y = i32.astype(np.float32) / 8388608.0
    else:
        raise ValueError(f"unsupported WAV sample width {width} in {path!r}")
    if channels > 1:
        y = y.reshape(-1, channels).mean(axis=1)  # librosa mono=True semantics
    return y, sr


def load_audio(
    path: str,
    *,
    sr: int | None = None,
    offset: float = 0.0,
    duration: float | None = None,
) -> tuple[np.ndarray, int]:
    """float32 mono waveform (librosa.load contract: resampled iff ``sr``)."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".wav":
        try:
            y, native_sr = _decode_wav(path)
        except wave.Error:
            sf = _soundfile()  # IEEE-float / extensible WAVs (see audio_info)
            if sf is None:
                raise
            y, native_sr = sf.read(path, dtype="float32", always_2d=False)
            if y.ndim > 1:
                y = y.mean(axis=1)
    elif ext == ".flac":
        from audioanalysisdetector_tpu_torch.io.flac import read_flac

        y, native_sr = read_flac(path)
    else:
        sf = _soundfile()
        if sf is None:
            raise RuntimeError(f"cannot decode {path!r}: unsupported container")
        y, native_sr = sf.read(path, dtype="float32", always_2d=False)
        if y.ndim > 1:
            y = y.mean(axis=1)
    if offset or duration is not None:
        start = int(offset * native_sr)
        stop = start + int(duration * native_sr) if duration is not None else len(y)
        y = y[start:stop]
    if sr is not None and sr != native_sr:
        y = resample_poly_host(y, native_sr, sr)
        native_sr = sr
    return np.ascontiguousarray(y, dtype=np.float32), native_sr


def resample_poly_host(y: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase host resample (scipy), gain-preserving."""
    from math import gcd

    from scipy.signal import resample_poly

    g = gcd(orig_sr, target_sr)
    return resample_poly(y, target_sr // g, orig_sr // g).astype(np.float32)


def write_wav(path: str, y: np.ndarray, sr: int) -> None:
    """16-bit PCM writer (for fixtures and smoke configs)."""
    y16 = np.clip(np.asarray(y, dtype=np.float64) * 32767.0, -32768, 32767).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(y16.tobytes())


def load_chunk_batch(
    paths: list[str],
    chunk_starts: list[float],
    chunk_ends: list[float],
    *,
    sr: int = 16000,
) -> np.ndarray:
    """Decode a batch of fixed-length chunks -> (B, n_samples) float32.

    Short reads are zero-padded to the chunk length (static shapes for jit).
    """
    if not paths:
        return np.zeros((0, 0), dtype=np.float32)
    n = int(round((chunk_ends[0] - chunk_starts[0]) * sr))
    out = np.zeros((len(paths), n), dtype=np.float32)
    for i, (p, s, e) in enumerate(zip(paths, chunk_starts, chunk_ends)):
        y, _ = load_audio(p, sr=sr, offset=s, duration=e - s)
        out[i, : min(len(y), n)] = y[:n]
    return out
