"""Operations and bytes of SSL-AASIST, from the configuration's shapes alone.

As ``counts.py``: one operation is one add or one multiply, and a layer
counts what its mathematics needs (2 per weight a position for every
convolution and linear layer; 2 per product term for the attention's
``Q K^T`` and ``A V`` and the graph layers' ``A x``); elementwise work
(norms, activations, softmax, the pairwise node products) is left out.
"""

from __future__ import annotations

# the TF32 dense tensor-core peak of one H100 SXM (data sheet, at 700 W);
# ``peaks.py`` holds the float32 and memory peaks
TF32_FLOP_PER_S = 494.7e12


def conv_lengths(cfg: dict) -> list[int]:
    """Frames after each conv of the feature encoder (no padding)."""
    out, t = [], cfg["n_samples"]
    for k, s in zip(cfg["conv_kernels"], cfg["conv_strides"]):
        t = (t - k) // s + 1
        out.append(t)
    return out


def frames(cfg: dict) -> int:
    return conv_lengths(cfg)[-1]


def xlsr_ops(cfg: dict) -> dict[str, float]:
    """One utterance through XLS-R, by part."""
    c, d, f = cfg["conv_dim"], cfg["hidden"], cfg["ffn"]
    lengths = conv_lengths(cfg)
    c_in = [1] + [c] * (len(lengths) - 1)
    t = lengths[-1]
    conv = sum(2.0 * c * ci * k * n for ci, k, n in zip(c_in, cfg["conv_kernels"], lengths))
    layer_linear = (4 * 2.0 * d * d + 2 * 2.0 * d * f) * t
    attention = 2 * 2.0 * t * t * d
    return {"conv": conv, "proj": 2.0 * c * d * t,
            "pos_conv": 2.0 * d * (d // cfg["pos_groups"]) * cfg["pos_kernel"] * t,
            "layers": cfg["layers"] * (layer_linear + attention), "attention": cfg["layers"] * attention}


def _gat_ops(n: int, d_in: int, d_out: int) -> float:
    """A graph attention layer over ``n`` nodes: the attention projection of
    every pair, its weight vector, ``A x`` and the two output projections."""
    return n * n * (2.0 * d_in * d_out + 2.0 * d_out) + 2.0 * n * n * d_in + 2 * 2.0 * n * d_in * d_out


def _htrg_ops(n1: int, n2: int, d_in: int, d_out: int) -> float:
    """An HS-GAL layer: the two type projections, the pairwise attention as
    ``_gat_ops``, and the master node's attention and projections."""
    n = n1 + n2
    master = n * (2.0 * d_in * d_out + 2.0 * d_out) + 2.0 * n * d_in + 2 * 2.0 * d_in * d_out
    return 2.0 * n * d_in * d_in + _gat_ops(n, d_in, d_out) + master


def aasist_ops(cfg: dict) -> float:
    """One utterance through the back end (``models/aasist.py``'s shapes)."""
    t = frames(cfg)
    ll = cfg["ll_dim"]
    ops = 2.0 * cfg["hidden"] * ll * t
    h, w = ll // 3, t // 3
    for c_in, c_out in cfg["filters"]:
        ops += 2.0 * c_out * c_in * 6 * (h + 1) * w  # conv1 (2, 3), one row taller
        ops += 2.0 * c_out * c_out * 6 * h * w  # conv2 (2, 3)
        if c_in != c_out:
            ops += 2.0 * c_out * c_in * 3 * h * w  # conv_downsample (1, 3)
    c = cfg["filters"][-1][1]
    ops += 2 * 2.0 * c * 2 * c * h * w  # the 1x1 attention map, 64 -> 128 -> 64
    ops += 2 * 2.0 * c * h * w  # the two weighted sums
    d0, d1 = cfg["gat_dims"]
    r = cfg["pool_ratio"]
    ops += _gat_ops(h, c, d0) + _gat_ops(w, c, d0) + 2.0 * (h + w) * d0  # and the two pools' projections
    ns, nt = int(h * r), int(w * r)
    for _ in range(2):  # two branches
        ops += _htrg_ops(nt, ns, d0, d1) + 2.0 * (ns + nt) * d1
        ops += _htrg_ops(int(nt * r), int(ns * r), d1, d1)
    return ops + 2.0 * 5 * d1 * 2


def score_ops(cfg: dict) -> float:
    """One utterance through the scorer: XLS-R, then AASIST."""
    x = xlsr_ops(cfg)
    return x["conv"] + x["proj"] + x["pos_conv"] + x["layers"] + aasist_ops(cfg)


def attention_bound(cfg: dict, rows: int) -> dict:
    """The least time the card could take for one layer's attention over
    ``rows`` utterances: ``Q K^T`` and ``A V`` (4 B H T^2 d operations) at
    the TF32 dense tensor peak (torch's float32 memory-efficient attention
    may run its products on the tensor cores, as 3xTF32), or Q, K, V and
    the output read or written once at the memory peak: the larger."""
    from portbench.yardstick.peaks import HBM_BYTES_PER_S

    t, d = frames(cfg), cfg["hidden"]
    ops = 4.0 * rows * t * t * d
    nbytes = 4 * rows * t * d * 4
    ops_s, bytes_s = ops / TF32_FLOP_PER_S, nbytes / HBM_BYTES_PER_S
    return {"bound_s": max(ops_s, bytes_s), "by": "operations" if ops_s >= bytes_s else "bytes",
            "ops": ops, "bytes": nbytes}
