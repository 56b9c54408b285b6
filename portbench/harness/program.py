"""What a system module's ``build`` returns: the scorer the window drives
and its two layers, which the traced run times apart."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch


@dataclass
class Program:
    score: Callable[[torch.Tensor], torch.Tensor]  # (B, n) waveforms -> (B,) scores, on the device
    frontend: Callable[[torch.Tensor], torch.Tensor]  # (B, n) -> features
    model: Callable[[torch.Tensor], torch.Tensor]  # features -> (B,) scores
