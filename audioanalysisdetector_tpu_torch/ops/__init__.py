"""Hand-written Hopper kernels, each beside its plain PyTorch version.

- ``wave_mel``     K1: mel power straight from padded waveforms (direct DFT).
- ``fused_logmel`` K2: mel power from frames gathered beforehand, f32 or
  bf16 operands (the K1 CUDA core, templated on the element type).
- ``ct_mel``       K3: mel power through a 64 x 32 Cooley-Tukey DFT of 2048
  (the parity mel step).

Import from the kernel's own module (``ops.wave_mel``): it also holds the
kernel's launch counter, which a re-export here would shadow.
``launch_counts`` and ``reset_launch_counts`` read and zero every counter:
each kernel's launches, and ``ct_mel.reflect``, K3's launches on a raw
waveform (the center reflect pad folded into its frame addressing).
``refuse_grad`` is the check each wrapper makes before a launch: no kernel
has a backward.
"""

from __future__ import annotations

import importlib

import torch

# counter name -> (module holding the kernel's wrapper, its counter)
COUNTERS = {
    "wave_mel": ("wave_mel", "launches"),
    "fused_mel_from_frames": ("fused_logmel", "launches"),
    "ct_mel": ("ct_mel", "launches"),
    "ct_mel.reflect": ("ct_mel", "reflect_launches"),
}


def _module(name: str):
    return importlib.import_module(f"{__name__}.{COUNTERS[name][0]}")


def launch_counts() -> dict[str, int]:
    """Kernel launches made in this process, by counter name."""
    return {name: getattr(_module(name), attr) for name, (_, attr) in COUNTERS.items()}


def reset_launch_counts() -> None:
    for name, (_, attr) in COUNTERS.items():
        setattr(_module(name), attr, 0)


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
