"""Entry point: the end-to-end forward (waveforms -> spoof scores).

Counterpart of ``__graft_entry__.py::entry``: the flagship CNN-BiLSTM on
log-mel features (parity profile), with example arguments.
"""

from __future__ import annotations

import numpy as np
import torch

from audioanalysisdetector_tpu_torch.frontend.mel import MelConfig
from audioanalysisdetector_tpu_torch.score.e2e import (
    init_mel_cnn_bilstm,
    make_mel_cnn_bilstm_scorer,
)


def entry(device: str | torch.device = "cuda"):
    """(fn, example_args): ``fn(wav)`` scores ``(8, 32000)`` waveforms on
    ``device``; weights from seed 0."""
    sr, seconds, batch = 16000, 2, 8
    mel_cfg = MelConfig(sr=sr, n_mels=64)
    model = init_mel_cnn_bilstm(mel_cfg, sr * seconds, seed=0, device=device)
    fn = make_mel_cnn_bilstm_scorer(model, mel_cfg)
    wav = np.random.default_rng(0).standard_normal((batch, sr * seconds)).astype(np.float32)
    return fn, (torch.from_numpy(wav).to(device),)
