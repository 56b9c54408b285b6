"""Operations and bytes of w2v-BERT 2.0 + MHFA, from the configuration's
shapes alone.

As ``counts.py`` counts: one operation is one add or one multiply; a layer
counts what its mathematics needs (2 per weight a frame for every linear
layer and convolution; 2 per product term for ``Q K^T``, ``A V`` and the
relative-key product ``q E^T`` over E's rows); elementwise work (norms,
swish, GLU, the softmaxes, the mask's gather) is left out. The filterbank
counts a real FFT of ``n_fft`` points a frame (2.5 N log2 N) and its
filters' nonzero weights (2 each).
"""

from __future__ import annotations

import math

import numpy as np

from portbench.yardstick.xlsr_aasist import TF32_FLOP_PER_S

__all__ = ["attention_bound", "fbank_ops", "frames", "layer_ops", "mhfa_ops", "rel_rows", "score_ops"]


def frames(cfg: dict) -> int:
    """Feature rows of one utterance: the Kaldi frames, paired."""
    return (1 + (cfg["n_samples"] - cfg["frame_length"]) // cfg["hop_length"]) // cfg["stride"]


def rel_rows(cfg: dict) -> int:
    return cfg["rel_left"] + cfg["rel_right"] + 1


def fbank_ops(cfg: dict) -> float:
    """One utterance's filterbank: every Kaldi frame's FFT and filters."""
    from portbench.reference.w2vbert_mhfa import _fbank_operands

    filters = _fbank_operands(cfg["frame_length"], cfg["n_fft"], cfg["n_mels"], cfg["sr"], cfg["fmin"],
                              cfg["fmax"], cfg["window_power"])[3]
    n = cfg["n_fft"]
    count = 1 + (cfg["n_samples"] - cfg["frame_length"]) // cfg["hop_length"]
    return count * (2.5 * n * math.log2(n) + 2.0 * int(np.count_nonzero(filters)))


def layer_ops(cfg: dict) -> dict[str, float]:
    """One utterance through one Conformer layer, by part."""
    t, d, f, h = frames(cfg), cfg["hidden"], cfg["ffn"], cfg["heads"]
    return {"ffn1": 2 * 2.0 * d * f * t, "ffn2": 2 * 2.0 * d * f * t,
            "attn_proj": 4 * 2.0 * d * d * t,
            "pointwise": (2.0 * d * 2 * d + 2.0 * d * d) * t,
            "depthwise": 2.0 * d * cfg["conv_kernel"] * t,
            "attention": 2 * 2.0 * t * t * d,  # Q K^T and A V over every head
            "rel_key": 2.0 * t * rel_rows(cfg) * (d // h) * h}  # q E^T


def mhfa_ops(cfg: dict) -> float:
    """One utterance through MHFA over its ``layers + 1`` hidden states."""
    t, d, c, h = frames(cfg), cfg["hidden"], cfg["mhfa_compression"], cfg["mhfa_heads"]
    mixes = 2 * 2.0 * (cfg["layers"] + 1) * d * t
    compress = 2 * 2.0 * d * c * t
    pooling = 2.0 * c * h * t + 2.0 * t * h * c  # the attention head, then A^T v
    return mixes + compress + pooling + 2.0 * h * c * cfg["mhfa_outputs"] + 2.0 * cfg["mhfa_outputs"] * 2


def score_ops(cfg: dict) -> float:
    """One utterance through the scorer: the filterbank, the projection, the
    layers, MHFA."""
    proj = 2.0 * cfg["n_mels"] * cfg["stride"] * cfg["hidden"] * frames(cfg)
    return fbank_ops(cfg) + proj + cfg["layers"] * sum(layer_ops(cfg).values()) + mhfa_ops(cfg)


def attention_bound(cfg: dict, rows: int) -> dict:
    """The least time the card could take for one layer's relative-key
    attention over ``rows`` utterances: ``Q K^T``, ``A V`` and ``q E^T``
    (``4 B T^2 d + 2 B T 73 d`` operations) at the TF32 dense tensor peak,
    or Q, K, V, the output and ``R = q E^T`` read or written once at the
    memory peak: the larger. The ``(B, H, T, T)`` mask is left out: a
    kernel can build it inside from R and the integer index."""
    from portbench.yardstick.peaks import HBM_BYTES_PER_S

    t, d, h = frames(cfg), cfg["hidden"], cfg["heads"]
    ops = 4.0 * rows * t * t * d + 2.0 * rows * t * rel_rows(cfg) * d
    nbytes = 4 * (4 * rows * t * d + rows * h * t * rel_rows(cfg))
    ops_s, bytes_s = ops / TF32_FLOP_PER_S, nbytes / HBM_BYTES_PER_S
    return {"bound_s": max(ops_s, bytes_s), "by": "operations" if ops_s >= bytes_s else "bytes",
            "ops": ops, "bytes": nbytes}
