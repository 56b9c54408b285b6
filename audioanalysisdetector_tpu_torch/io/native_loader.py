"""ctypes bindings for the native batch WAV/FLAC loader (``native/*.cpp``).

A copy of the JAX package's ``io/native_loader.py`` with one repair: that
module builds ``libwavloader.so`` next to the C++ sources, inside the
repository's ``native/`` directory, where it would overwrite the library
the JAX package builds and loads. This one compiles the same sources into
``build/native/`` beside the package (a directory git ignores), named by
the hash of the sources, so an edited source is rebuilt and an unchanged
one is reused. Outside a source tree (an installed wheel) it uses a
per-user cache directory, as the original does.

Every entry point degrades to the pure-Python loader in ``io.audio``: rows
the native path cannot handle (non-WAV container, a sample rate that needs
resampling, no ``g++``) are back-filled per row. That fallback is host
decode, not a device path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import wave
from pathlib import Path

import numpy as np

from audioanalysisdetector_tpu_torch.io.audio import AudioInfo, load_audio

_SRC_NAMES = ("wavloader.cpp", "flacdec.cpp")
_PKG_ROOT = Path(__file__).resolve().parents[1]


def _find_native_dir() -> Path | None:
    """The C++ sources: ``<repo>/native`` in a source tree, or the JAX
    package's ``native`` subpackage directory in an installed wheel (found
    by path: importing it would load jax)."""
    for cand in (_PKG_ROOT.parent / "native", _PKG_ROOT.parent / "audioanalysisdetector_tpu" / "native"):
        if all((cand / s).exists() for s in _SRC_NAMES):
            return cand
    return None


_NATIVE_DIR = _find_native_dir()
_SRCS = [_NATIVE_DIR / s for s in _SRC_NAMES] if _NATIVE_DIR is not None else []


def _lib_path() -> Path:
    """``build/native/libwavloader-<digest>.so`` beside the package in a
    source tree; a per-user cache directory otherwise."""
    h = hashlib.sha256()
    for s in _SRCS:
        h.update(s.read_bytes())
    name = f"libwavloader-{h.hexdigest()[:12]}.so"
    if (_PKG_ROOT.parent / "native").is_dir():
        return _PKG_ROOT.parent / "build" / "native" / name
    cache_root = os.environ.get("XDG_CACHE_HOME") or os.path.join(os.path.expanduser("~"), ".cache")
    return Path(cache_root) / "audioanalysisdetector_tpu_torch" / name


_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_build_failed = False


def _build(lib: Path) -> bool:
    # -march=native as in the original (the library is compiled on the host
    # that runs it); retried without the flag for exotic toolchains
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    for extra in (["-march=native"], []):
        try:
            subprocess.run(
                ["g++", "-O3", *extra, "-shared", "-fPIC", "-std=c++17",
                 "-pthread", *map(str, _SRCS), "-o", str(tmp)],
                check=True, capture_output=True, timeout=120,
            )
            os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
            return True
        except (OSError, subprocess.SubprocessError):
            continue
    tmp.unlink(missing_ok=True)
    return False


def get_lib() -> ctypes.CDLL | None:
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _build_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed or _NATIVE_DIR is None:
            return None
        path = _lib_path()
        if not path.exists() and not _build(path):
            _build_failed = True
            return None
        lib = ctypes.CDLL(str(path))
        info_argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.wav_info.restype = ctypes.c_int
        lib.wav_info.argtypes = info_argtypes
        lib.flac_info.restype = ctypes.c_int
        lib.flac_info.argtypes = info_argtypes
        lib.load_chunk_batch_rows.restype = ctypes.c_int
        lib.load_chunk_batch_rows.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.c_int32,
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            ctypes.c_int32,
        ]
        _lib = lib
        return _lib


def native_available() -> bool:
    return get_lib() is not None


def audio_info_native(path: str) -> AudioInfo | None:
    lib = get_lib()
    ext = path.lower()
    if lib is None or not ext.endswith((".wav", ".flac")):
        return None
    probe = lib.wav_info if ext.endswith(".wav") else lib.flac_info
    frames = ctypes.c_int64()
    sr = ctypes.c_int32()
    ch = ctypes.c_int32()
    if probe(path.encode(), ctypes.byref(frames), ctypes.byref(sr), ctypes.byref(ch)):
        return None
    return AudioInfo(frames=int(frames.value), samplerate=int(sr.value), channels=int(ch.value))


def load_chunk_batch_native(
    paths: list[str],
    chunk_starts: list[float],
    chunk_ends: list[float],
    *,
    sr: int = 16000,
    n_threads: int = 0,
    return_ok: bool = False,
    out: np.ndarray | None = None,
) -> np.ndarray | tuple[np.ndarray, np.ndarray]:
    """Threaded native batch fill -> (B, n_samples) float32.

    The native decoder writes straight into the final batch buffer (row
    indices passed down, short rows zero-padded in place). Rows the native
    decoder rejects fall back to the Python loader; with ``return_ok`` a
    boolean per-row success mask is returned too (the reference's
    failure->skip policy). ``out`` lets a steady-state pipeline reuse one
    batch buffer.
    """
    if not paths:
        empty = np.zeros((0, 0), dtype=np.float32)
        return (empty, np.zeros(0, dtype=bool)) if return_ok else empty
    n = int(round((chunk_ends[0] - chunk_starts[0]) * sr))
    if out is None:
        out = np.empty((len(paths), n), dtype=np.float32)
    elif (
        out.shape != (len(paths), n)
        or out.dtype != np.float32
        or not out.flags.c_contiguous
    ):
        raise ValueError(
            f"out must be C-contiguous float32 {(len(paths), n)}, got "
            f"{out.dtype} {out.shape}"
        )
    ok = np.ones(len(paths), dtype=bool)
    lib = get_lib()
    todo = list(range(len(paths)))
    if lib is not None:
        wav_rows = [i for i in todo if paths[i].lower().endswith((".wav", ".flac"))]
        if wav_rows:
            c_paths = (ctypes.c_char_p * len(wav_rows))(
                *[paths[i].encode() for i in wav_rows]
            )
            starts = np.asarray([chunk_starts[i] for i in wav_rows], np.float64)
            rows = np.asarray(wav_rows, dtype=np.int32)
            status = np.zeros(len(wav_rows), dtype=np.int32)
            lib.load_chunk_batch_rows(
                c_paths, starts, rows, len(wav_rows), n, sr, out, status, n_threads
            )
            done = {i for j, i in enumerate(wav_rows) if status[j] == 0}
            todo = [i for i in todo if i not in done]
    for i in todo:  # python fallback (non-WAV, rate mismatch, errors)
        out[i] = 0.0
        try:
            y, _ = load_audio(
                paths[i], sr=sr, offset=chunk_starts[i],
                duration=chunk_ends[i] - chunk_starts[i],
            )
            out[i, : min(len(y), n)] = y[:n]
        except (RuntimeError, OSError, EOFError, ValueError, wave.Error):
            ok[i] = False  # row left zeroed; caller may drop it
    if return_ok:
        return out, ok
    return out
