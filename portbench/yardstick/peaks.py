"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, at 700 W).

Parity mode runs IEEE float32 with TF32 off, so float32 outside the tensor
cores is the peak that rates and rooflines are held to.
"""

from __future__ import annotations

import subprocess

FP32_FLOP_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them, or
    why they could not be read: every share of a peak is printed beside it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "nvidia-smi failed"
