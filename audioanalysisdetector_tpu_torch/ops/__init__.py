"""Hand-written Hopper kernels, each beside its plain PyTorch version.

- ``wave_mel``     K1: mel power straight from padded waveforms (direct DFT).
- ``fused_logmel`` K2: mel power from frames gathered beforehand, f32 or
  bf16 operands (the K1 CUDA core, templated on the element type).
- ``ct_mel``       K3: mel power through a 64 x 32 Cooley-Tukey DFT of 2048
  (the parity mel step).

Import from the kernel's own module (``ops.wave_mel``): it also holds the
kernel's launch counter, which a re-export here would shadow.
``launch_counts`` and ``reset_launch_counts`` read and zero every counter.
``refuse_grad`` is the check each wrapper makes before a launch: no kernel
has a backward.
"""

from __future__ import annotations

import importlib

import torch

# kernel name -> module holding its wrapper and ``launches`` counter
KERNELS = {
    "wave_mel": "wave_mel",
    "fused_mel_from_frames": "fused_logmel",
    "ct_mel": "ct_mel",
}


def _module(name: str):
    return importlib.import_module(f"{__name__}.{KERNELS[name]}")


def launch_counts() -> dict[str, int]:
    """Kernel launches made in this process, by kernel name."""
    return {name: _module(name).launches for name in KERNELS}


def reset_launch_counts() -> None:
    for name in KERNELS:
        _module(name).launches = 0


def refuse_grad(x: torch.Tensor, kernel: str) -> None:
    """Raise when autograd would need ``kernel``'s backward: grad mode is on
    and ``x`` requires grad. The kernels, like the JAX package's Pallas
    kernels, have none, and a launch through ctypes would cut the gradient
    silently (the plain versions on the CPU keep it)."""
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError(
            f"{kernel}: the mel kernels have no backward, as the JAX package's "
            "Pallas kernels have none, and this input requires grad; extract "
            "features under torch.no_grad()"
        )
