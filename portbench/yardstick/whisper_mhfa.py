"""Operations and bytes of Whisper large-v3's encoder + MHFA, from the
configuration's shapes alone.

As ``counts.py`` counts: one operation is one add or one multiply; a layer
counts what its mathematics needs (2 per weight a frame for every linear
layer and convolution; 2 per product term for ``Q K^T`` and ``A V``);
elementwise work (norms, GELU, the softmaxes, the log-mel's normalisation)
is left out. The log-mel counts every frame K1 computes
(``counts.mel_frame_ops``: a real FFT of ``n_fft`` points, the window,
|X|^2 and the mel weights), the dropped last one too.
"""

from __future__ import annotations

from portbench.yardstick import counts
from portbench.yardstick.xlsr_aasist import TF32_FLOP_PER_S

__all__ = ["attention_bound", "frames", "layer_ops", "logmel_ops", "mhfa_ops", "positions", "score_ops",
           "stem_ops"]


def frames(cfg: dict) -> int:
    """Mel frames the encoder reads: the centred STFT's, less the last."""
    return counts.frames(cfg["n_samples"], cfg["hop_length"]) - 1


def positions(cfg: dict) -> int:
    """Frames after the stem's stride-2 conv (kernel 3, one frame of padding)."""
    return (frames(cfg) - 1) // 2 + 1


def logmel_ops(cfg: dict) -> float:
    """One utterance's log-mel: every frame of the centred STFT."""
    return counts.frames(cfg["n_samples"], cfg["hop_length"]) * counts.mel_frame_ops(cfg)


def stem_ops(cfg: dict) -> float:
    """One utterance through both convs of the stem (kernel 3)."""
    d = cfg["hidden"]
    return 2.0 * cfg["n_mels"] * 3 * d * frames(cfg) + 2.0 * d * 3 * d * positions(cfg)


def layer_ops(cfg: dict) -> dict[str, float]:
    """One utterance through one encoder layer, by part."""
    t, d, f = positions(cfg), cfg["hidden"], cfg["ffn"]
    return {"attn_proj": 4 * 2.0 * d * d * t, "ffn": 2 * 2.0 * d * f * t,
            "attention": 2 * 2.0 * t * t * d}  # Q K^T and A V over every head


def mhfa_ops(cfg: dict) -> float:
    """One utterance through MHFA over its ``layers + 1`` hidden states."""
    t, d, c, h = positions(cfg), cfg["hidden"], cfg["mhfa_compression"], cfg["mhfa_heads"]
    mixes = 2 * 2.0 * (cfg["layers"] + 1) * d * t
    compress = 2 * 2.0 * d * c * t
    pooling = 2.0 * c * h * t + 2.0 * t * h * c  # the attention head, then A^T v
    return mixes + compress + pooling + 2.0 * h * c * cfg["mhfa_outputs"] + 2.0 * cfg["mhfa_outputs"] * 2


def score_ops(cfg: dict) -> float:
    """One utterance through the scorer: the log-mel, the stem, the layers,
    MHFA."""
    return logmel_ops(cfg) + stem_ops(cfg) + cfg["layers"] * sum(layer_ops(cfg).values()) + mhfa_ops(cfg)


def attention_bound(cfg: dict, rows: int) -> dict:
    """The least time the card could take for one layer's attention over
    ``rows`` utterances: ``Q K^T`` and ``A V`` (``4 B T^2 d`` operations) at
    the TF32 dense tensor peak, or Q, K, V and the output read or written
    once at the memory peak: the larger. There is no mask."""
    from portbench.yardstick.peaks import HBM_BYTES_PER_S

    t, d = positions(cfg), cfg["hidden"]
    ops = 4.0 * rows * t * t * d
    nbytes = 4 * 4 * rows * t * d
    ops_s, bytes_s = ops / TF32_FLOP_PER_S, nbytes / HBM_BYTES_PER_S
    return {"bound_s": max(ops_s, bytes_s), "by": "operations" if ops_s >= bytes_s else "bytes",
            "ops": ops, "bytes": nbytes}
