"""Causal grouped-query attention on Hopper's tensor cores at float32 accuracy: the hand-written kernel K8.

The JAX package has no such kernel (it has no Voxtral); K8 replaces the
Voxtral decoder's attention (``models/voxtral.py::lm_attend``): K and V
expanded to the query heads, PyTorch's float32 memory-efficient attention
and the merge copy. Float32 ``q`` ``(B, H, T, 128)``, ``k`` and ``v`` ``(B,
H_kv, T, 128)``, query head ``h`` reading KV head ``h // (H / H_kv)``, into
``softmax(q k^T / sqrt(128) + causal) v`` as ``(B, T, H 128)``. Every
operand is split into three bf16 planes that sum to it exactly
(``split3``), both products are the six part products of order 2^-16 and
up on ``wgmma``, each ``CHUNK``-deep chunk summed on the tensor cores from
zero and the chunks in IEEE float32, and the softmax runs online in
float32. Design and bound: ``ops/csrc/lm_attention.cu``.

Two kernels: ``lm_planes_launch`` (``planes``) lays q, k and v out as the
kernel's planes (``query_planes`` and ``kv_planes`` are its plain
version), ``lm_attention_launch`` runs the attention. A block computes
``ROWS`` query rows, the ``H / H_kv`` heads that read one KV head at ``ROWS
H_kv / H`` positions each, so a KV tile is read once for all of them.

``lm_attention`` launches both on CUDA tensors, counted as
``lm_attention.planes`` and ``lm_attention``; on a CPU tensor it runs
``lm_attention_reference``, the plain PyTorch version of the same
arithmetic. There is no fallback: a failed build or a refused launch raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from audioanalysisdetector_tpu_torch.ops import _build, launch, on_card
from audioanalysisdetector_tpu_torch.ops.split_gemm import PARTS, PRODUCTS, split3

HEAD_DIM = 128  # the one head size the kernel takes (D in csrc/lm_attention.cu)
ROWS = 128  # query rows a block: two consumer warpgroups of 64
BLOCK_KV = 64  # key/value positions a tile (BKV)
CHUNK = 32  # depth summed on the tensor cores from zero
ITEM = PARTS * HEAD_DIM * CHUNK  # bf16 elements of one streamed item: half a K tile or half a V tile
GROUPS = (1, 2, 4, 8, 16)  # query heads a KV head: a warpgroup's 64 rows hold whole heads
_ptr, _int, _long = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_PLANES_ARGTYPES = (_ptr,) * 5 + (_int,) * 4 + (_long,) * 9 + (_ptr,)
_ATTENTION_ARGTYPES = (_ptr,) * 3 + (_int,) * 4 + (_ptr,)


def log2e_scale(d: int) -> float:
    """``log2(e) / sqrt(d)`` rounded to float32: the factor that takes a
    score to the base-2 exponent of its softmax term."""
    return float(torch.tensor(math.log2(math.e) / math.sqrt(d), dtype=torch.float32))


def positions_a_tile(heads: int, kv_heads: int) -> int:
    """Positions of one q tile: ``ROWS`` rows over the group's heads."""
    return ROWS * kv_heads // heads


def _core(x: torch.Tensor) -> torch.Tensor:
    """``(..., R, K)`` -> ``(..., K / CHUNK, R CHUNK)``: each ``R x CHUNK``
    block in the wgmma K-major core-matrix layout (8 x 8 core matrices,
    K-fastest within an 8-row group, the groups one after another)."""
    *lead, r, k = x.shape
    n = len(lead)
    y = x.reshape(*lead, r // 8, 8, k // CHUNK, CHUNK // 8, 8)
    return y.permute(*range(n), n + 2, n, n + 3, n + 1, n + 4).reshape(*lead, k // CHUNK, r * CHUNK)


def _pad(x: torch.Tensor, length: int) -> torch.Tensor:
    """``(B, H, T, d)`` zero-padded along T to ``length``."""
    out = x.new_zeros(*x.shape[:2], length, x.shape[3])
    out[:, :, :x.shape[2]] = x
    return out


def query_planes(q: torch.Tensor, kv_heads: int) -> torch.Tensor:
    """Plain version of the query half of ``lm_planes_launch``: float32 ``q``
    ``(B, H, T, 128)`` -> bf16 ``(B, H_kv, q_tiles, 128 / CHUNK, PARTS,
    ROWS CHUNK)``. Row ``r`` of q tile ``i`` of KV head ``g`` is query head
    ``g G + (r % 64) // (64 / G)`` at position ``i P + (r // 64) P / 2 + r %
    (64 / G)``, with ``G = H / H_kv`` and ``P = positions_a_tile``;
    positions past T are zero."""
    b, h, t, d = q.shape
    group, span = h // kv_heads, positions_a_tile(h, kv_heads)
    tiles = -(-t // span)
    x = _pad(q, tiles * span).view(b, kv_heads, group, tiles, 2, span // 2, d)
    x = x.permute(0, 1, 3, 4, 2, 5, 6).reshape(b, kv_heads, tiles, ROWS, d)  # rows: (warpgroup, head, position)
    parts = _core(torch.stack(split3(x), dim=3))  # (B, H_kv, tiles, part, chunk, ROWS CHUNK)
    return parts.transpose(3, 4).contiguous()


def kv_planes(k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain version of the key/value half of ``lm_planes_launch``: float32
    ``k`` and ``v`` ``(B, H_kv, T, 128)`` -> bf16 ``(B, H_kv, kv_tiles, 4,
    ITEM)``: items 0 and 1 K's tile at depth chunks 0-1 and 2-3 (``(2,
    PARTS, 64 CHUNK)`` each), items 2 and 3 V's tile transposed at positions
    0-31 and 32-63 (``(PARTS, 128 CHUNK)``: 128 depth rows, CHUNK
    positions); positions past T are zero."""
    b, hk, t, d = k.shape
    tiles = -(-t // BLOCK_KV)
    kt = _pad(k, tiles * BLOCK_KV).view(b, hk, tiles, BLOCK_KV, d)
    vt = _pad(v, tiles * BLOCK_KV).view(b, hk, tiles, BLOCK_KV, d).transpose(3, 4)
    k_parts = _core(torch.stack(split3(kt), dim=3))  # (B, H_kv, tiles, part, chunk, 64 CHUNK)
    v_parts = _core(torch.stack(split3(vt), dim=3))  # (B, H_kv, tiles, part, half, 128 CHUNK)
    k_items = k_parts.transpose(3, 4).reshape(b, hk, tiles, 2, ITEM)
    v_items = v_parts.transpose(3, 4).reshape(b, hk, tiles, 2, ITEM)
    return torch.cat([k_items, v_items], dim=3)


def _chunk_products(xs: tuple[torch.Tensor, ...], ys: tuple[torch.Tensor, ...]) -> torch.Tensor:
    """The six part products of one chunk, ``x_i @ y_j`` over ``PRODUCTS``,
    summed in float32 (the tensor cores sum them toward zero)."""
    return sum(xs[i].float() @ ys[j].float() for i, j in PRODUCTS)


def attention_from_parts(qs: tuple[torch.Tensor, ...], ks: tuple[torch.Tensor, ...],
                         vs: tuple[torch.Tensor, ...]) -> torch.Tensor:
    """K8's arithmetic on split operands: the three bf16 parts of ``q`` ``(B,
    H, T, d)`` and of ``k`` and ``v`` ``(B, H_kv, T, d)`` -> float32 ``(B, T,
    H d)``. Tile by tile of ``BLOCK_KV`` positions: S = the chunks of
    ``CHUNK`` along d, each its six part products, added in order; the
    columns past a row's position at -inf; the online softmax in float32
    (the running max times ``log2e_scale``, P = exp2(s c - m), the output
    and the row sums rescaled by exp2(m_old - m)); P split in three; O =
    O alpha + the six part products of each ``CHUNK`` of the tile's
    positions, in order; last O / l. The kernel visits only the tiles at or
    below its block's diagonal: a tile wholly past a row's position leaves
    that row's sums bit for bit as they were (P 0, alpha 1)."""
    b, h, t, d = qs[0].shape
    group = h // ks[0].shape[1]
    ks = tuple(x.repeat_interleave(group, dim=1) for x in ks)
    vs = tuple(x.repeat_interleave(group, dim=1) for x in vs)
    c = log2e_scale(d)
    dev = qs[0].device
    o = torch.zeros(b, h, t, d, dtype=torch.float32, device=dev)
    m = torch.full((b, h, t, 1), -math.inf, dtype=torch.float32, device=dev)
    l = torch.zeros(b, h, t, 1, dtype=torch.float32, device=dev)
    rows = torch.arange(t, device=dev)[:, None]
    for j0 in range(0, t, BLOCK_KV):
        j1 = min(j0 + BLOCK_KV, t)
        kt = tuple(x[:, :, j0:j1].transpose(2, 3) for x in ks)
        s = None
        for c0 in range(0, d, CHUNK):
            part = _chunk_products(tuple(x[..., c0:c0 + CHUNK] for x in qs), tuple(x[:, :, c0:c0 + CHUNK] for x in kt))
            s = part if s is None else s + part
        s = s.masked_fill(torch.arange(j0, j1, device=dev)[None, :] > rows, -math.inf)
        new = torch.maximum(m, s.amax(dim=-1, keepdim=True) * c)
        alpha = torch.exp2(m - new)
        # exp2(fma(s, c, -new)): s c is exact in float64, the sum rounded once more
        p = torch.exp2((s.double() * c - new.double()).float())
        l = (l.double() * alpha.double() + p.sum(dim=-1, keepdim=True).double()).float()
        m = new
        o = o * alpha
        ps = split3(p)
        for p0 in range(0, j1 - j0, CHUNK):
            o = o + _chunk_products(tuple(x[..., p0:p0 + CHUNK] for x in ps),
                                    tuple(x[:, :, j0 + p0:min(j0 + p0 + CHUNK, j1)] for x in vs))
    return (o / l).transpose(1, 2).reshape(b, t, h * d)


def lm_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K8: ``attention_from_parts`` of the three
    parts of each float32 operand. Its products of bf16 values are exact;
    its sums round to nearest, where the tensor cores round toward zero."""
    return attention_from_parts(split3(q), split3(k), split3(v))


def refusals(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> list[str]:
    """Why K8 cannot compute ``lm_attend``, each reason by name, or an empty
    list: K8 takes float32 operands on the card, no backward (autograd would
    need one when grad mode is on and an operand requires grad), ``q`` ``(B,
    H, T, 128)`` with ``k`` and ``v`` ``(B, H_kv, T, 128)`` and ``H / H_kv``
    among ``GROUPS``, and strides it can read: the head size contiguous,
    every address and stride 16-byte aligned."""
    ops = (q, k, v)
    why = []
    if not all(x.is_cuda for x in ops):
        why.append("device")
    if any(x.dtype != torch.float32 for x in ops):
        why.append("dtype")
    if torch.is_grad_enabled() and any(x.requires_grad for x in ops):
        why.append("grad")
    shaped = all(x.dim() == 4 for x in ops) and k.shape == v.shape and q.shape[0] == k.shape[0] and \
        q.shape[2:] == k.shape[2:] and q.shape[2] > 0 and k.shape[1] > 0 and q.shape[1] % k.shape[1] == 0
    if not shaped:
        why.append("shape")
        return why
    if q.shape[-1] != HEAD_DIM:
        why.append("head_dim")
    if q.shape[1] // k.shape[1] not in GROUPS:
        why.append("group")
    if any(x.stride(-1) != 1 or any(s < 0 or s % 4 for s in x.stride()[:3]) or x.data_ptr() % 16 for x in ops):
        why.append("strides")
    return why


def planes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``lm_planes_launch`` on CUDA tensors, counted as
    ``lm_attention.planes``: the bits of ``query_planes(q, H_kv)`` and
    ``kv_planes(k, v)``."""
    b, h, t, d = q.shape
    hk = k.shape[1]
    q_tiles, kv_tiles = -(-t // positions_a_tile(h, hk)), -(-t // BLOCK_KV)
    qp = torch.empty((b, hk, q_tiles, d // CHUNK, PARTS, ROWS * CHUNK), dtype=torch.bfloat16, device=q.device)
    kvp = torch.empty((b, hk, kv_tiles, 4, ITEM), dtype=torch.bfloat16, device=q.device)
    launch(_build.entry_point("lm_attention", "lm_planes_launch", _PLANES_ARGTYPES), q, "lm_attention.planes",
           q.data_ptr(), k.data_ptr(), v.data_ptr(), qp.data_ptr(), kvp.data_ptr(), b, h, hk, t,
           *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], rows=b * t)
    return qp, kvp


def lm_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``softmax(q k^T / sqrt(d) + causal) v`` as ``(B, T, H d)``. On CUDA
    tensors one split of q, k and v into their planes and one K8 launch;
    on CPU tensors ``lm_attention_reference``. The caller checks
    ``refusals`` first."""
    if not on_card(q, "lm_attention"):
        return lm_attention_reference(q, k, v)
    b, h, t, d = q.shape
    hk = k.shape[1]
    qp, kvp = planes(q, k, v)
    out = q.new_empty((b, t, h * d))
    launch(_build.entry_point("lm_attention", "lm_attention_launch", _ATTENTION_ARGTYPES), q, "lm_attention",
           qp.data_ptr(), kvp.data_ptr(), out.data_ptr(), b, h, hk, t, rows=b * t)
    return out
