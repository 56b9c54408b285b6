"""Build the hand-written CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``ops/csrc/<name>.cu`` exposes a plain C entry point, so it compiles in
seconds without PyTorch's headers. ``load_library(name)`` compiles it at
first use into ``build/torch_kernels/`` beside the package (a directory git
ignores), named by the hash of the source and flags, so an edited source is
rebuilt and an unchanged one is reused. ``entry_point`` returns one of its C
functions, typed and cached. Each source has its own lock, so
threads that load different kernels run their ``nvcc`` builds in parallel.
``nvcc`` is ``$CUDA_HOME/bin/nvcc`` (``/usr/local/cuda`` when unset) or the
one on ``PATH``. There is no fallback: a missing compiler or a failed build
raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from collections.abc import Callable
from functools import lru_cache
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_locks_lock = threading.Lock()
_locks: dict[str, threading.Lock] = {}
_loaded: dict[str, ctypes.CDLL] = {}
# per kernel: seconds this process spent compiling it (0.0 when the library
# was already built) and nvcc's output, which carries ptxas's register,
# shared-memory and spill report
build_log: dict[str, dict] = {}


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            f"nvcc not found at {cand} or on PATH: the CUDA kernels cannot be built"
        )
    return found


def load_library(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if needed and return the loaded library."""
    with _locks_lock:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        if name in _loaded:
            return _loaded[name]
        src = CSRC / f"{name}.cu"
        digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
        lib = BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"
        seconds, output = 0.0, ""
        if not lib.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = lib.with_suffix(f".{os.getpid()}.tmp")
            t0 = time.perf_counter()
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                capture_output=True,
                text=True,
            )
            seconds = time.perf_counter() - t0
            output = proc.stdout + proc.stderr
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"nvcc failed to build {src.name}:\n{output}")
            os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
        build_log[name] = {"seconds": seconds, "output": output, "path": str(lib)}
        _loaded[name] = ctypes.CDLL(str(lib))
        return _loaded[name]


@lru_cache(maxsize=None)
def entry_point(name: str, symbol: str, argtypes: tuple) -> Callable[..., int]:
    """``symbol`` of ``csrc/<name>.cu`` (built at first use) with its C
    parameter types ``argtypes``, the CUDA stream last, returning its
    ``cudaError_t`` as an int."""
    fn = getattr(load_library(name), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn
