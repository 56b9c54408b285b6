"""Operations of WavLM-Large + MHFA, from the configuration's shapes alone.

As ``xlsr_aasist.py`` counts XLS-R (WavLM's stack has XLS-R's shapes),
plus WavLM's gate, ``grep_linear`` over each head's 64 inputs in every
layer, and MHFA's products: the two layer mixes, the two compressions, the
attention head, the pooling ``A^T v``, ``pooling_fc`` and the output layer.
The gated bias ``G P`` and the softmaxes are elementwise and left out.
The attention's roofline is XLS-R's (``xlsr_aasist.py::attention_bound``,
read by ``xlsr.attention_roofline``): it counts only ``Q K^T`` and ``A V``,
since the bias is a 320 x 16 table and a (B, H, T) gate that a kernel can
build inside.
"""

from __future__ import annotations

from portbench.yardstick.xlsr_aasist import frames, xlsr_ops

__all__ = ["frames", "gate_ops", "mhfa_ops", "score_ops"]


def gate_ops(cfg: dict) -> float:
    """One utterance's gates over every layer: ``grep_linear`` (head size
    -> 8) for each head and frame."""
    return cfg["layers"] * 2.0 * cfg["hidden"] * 8 * frames(cfg)


def mhfa_ops(cfg: dict) -> float:
    """One utterance through MHFA over its ``layers + 1`` hidden states."""
    t, d, c, h = frames(cfg), cfg["hidden"], cfg["mhfa_compression"], cfg["mhfa_heads"]
    mixes = 2 * 2.0 * (cfg["layers"] + 1) * d * t
    compress = 2 * 2.0 * d * c * t
    pooling = 2.0 * c * h * t + 2.0 * t * h * c  # the attention head, then A^T v
    return mixes + compress + pooling + 2.0 * h * c * cfg["mhfa_outputs"] + 2.0 * cfg["mhfa_outputs"] * 2


def score_ops(cfg: dict) -> float:
    """One utterance through the scorer: WavLM, then MHFA."""
    x = xlsr_ops(cfg)
    return x["conv"] + x["proj"] + x["pos_conv"] + x["layers"] + gate_ops(cfg) + mhfa_ops(cfg)
