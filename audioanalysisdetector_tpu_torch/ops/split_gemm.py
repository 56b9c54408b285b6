"""Float32 matrix products on Hopper's tensor cores at float32 accuracy: the hand-written kernel K7.

The JAX package has no such kernel (XLA runs its linear layers); K7 replaces
a library call, cuBLAS's float32 SIMT SGEMM under ``nn.Linear``, in the
Voxtral decoder's projections (``models/voxtral.py::DecoderLayer``), where
the layer can observe that it runs on the card with no backward to come
(``refusals``). ``y = x W^T`` for float32 ``x`` ``(..., K)`` and ``W`` ``(N,
K)``: each operand is split into three bf16 planes that sum to it exactly
(``split3``), the six part products of order 2^-16 and up run on ``wgmma``,
each chunk of ``CHUNK`` along K summed on the tensor cores from zero and the
chunks in IEEE float32. Design and bound: ``ops/csrc/split_gemm.cu``.

Two kernels: ``split_planes_launch`` lays a float32 matrix out as the
product's planes (``plane_layout`` is its plain version), ``split_gemm_launch``
runs the product. A weight's planes are made once and kept by a
``WeightPlanes``, which makes them again when a weight changes (its
``data_ptr`` or ``_version``) and may hold several weights of one K side by
side along N, so that one launch computes their outputs together. The
activations are split before each product.

``split_linear`` launches both on CUDA tensors, counted as
``split_gemm.planes`` and ``split_gemm``; on a CPU tensor it runs
``split_gemm_reference``, the plain PyTorch version of the same arithmetic.
There is no fallback: a failed build or a refused launch raises.
"""

from __future__ import annotations

import ctypes

import torch

from audioanalysisdetector_tpu_torch.ops import _build, launch, on_card

BLOCK_M = 128  # rows of y a block, and the tile rows of the x planes (BM in csrc/split_gemm.cu)
BLOCK_N = 192  # columns of y a block, and the tile rows of the W planes (BN)
CHUNK = 32  # K a stage, summed on the tensor cores from zero (BK)
PARTS = 3
# the six part products (x part, W part) of order 2^-16 and up (0 hi, 1 mid, 2 lo)
PRODUCTS = ((1, 1), (0, 2), (2, 0), (0, 1), (1, 0), (0, 0))
_SPLIT_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p)
_GEMM_ARGTYPES = (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 3 + (ctypes.c_void_p,)


def split3(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """float32 ``x`` -> bf16 ``(hi, mid, lo)``, each the rounding to nearest
    of what the ones before leave. For finite ``|x|`` below bf16's largest
    value they sum to ``x`` exactly down to ``|x| >= 2**-110``; below that
    (float32's subnormals among them) the sum is within half of bf16's
    smallest subnormal, ``2**-134``, of ``x``."""
    hi = x.to(torch.bfloat16)
    rest = x - hi.float()
    mid = rest.to(torch.bfloat16)
    return hi, mid, (rest - mid.float()).to(torch.bfloat16)


def plane_layout(x: torch.Tensor, tile_rows: int) -> torch.Tensor:
    """Plain version of ``split_planes_launch``: float32 ``(rows, K)`` ->
    bf16 ``(ceil(rows / tile_rows), K / CHUNK, PARTS, tile_rows * CHUNK)``,
    each ``tile_rows x CHUNK`` block of each part in the wgmma K-major
    core-matrix layout (8 x 8 core matrices, K-fastest within an 8-row group,
    the groups one after another), rows past ``x`` zero."""
    rows, k = x.shape
    tiles = -(-rows // tile_rows)
    padded = x.new_zeros(tiles * tile_rows, k)
    padded[:rows] = x
    parts = torch.stack(split3(padded))  # (PARTS, rows, K)
    # (part, tile, row group, row, chunk, k group, k) -> (tile, chunk, part, row group, k group, row, k)
    blocks = parts.view(PARTS, tiles, tile_rows // 8, 8, k // CHUNK, CHUNK // 8, 8).permute(1, 4, 0, 2, 5, 3, 6)
    return blocks.reshape(tiles, k // CHUNK, PARTS, tile_rows * CHUNK)


def split_gemm_reference(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K7: ``(..., K)`` float32 ``x`` and ``(N, K)``
    ``W`` -> ``(..., N)``. Both split in three (``split3``); for each chunk
    of ``CHUNK`` along K the six part products (``PRODUCTS``) summed in
    float32, then the chunks added in order in float32. Its products of bf16
    values are exact; its sums within a chunk round to nearest, where the
    tensor cores round toward zero."""
    lead, k = x.shape[:-1], x.shape[-1]
    return products(split3(x.reshape(-1, k)), split3(w)).view(*lead, w.shape[0])


def products(xs: tuple[torch.Tensor, ...], ws: tuple[torch.Tensor, ...]) -> torch.Tensor:
    """K7's arithmetic on split operands: the three bf16 parts of ``x`` ``(M,
    K)`` and of ``W`` ``(N, K)`` -> float32 ``(M, N)``, the six part products
    of each ``CHUNK`` of K summed, then the chunks added in order."""
    y = torch.zeros(xs[0].shape[0], ws[0].shape[0], dtype=torch.float32, device=xs[0].device)
    for c in range(0, xs[0].shape[1], CHUNK):
        y += sum(xs[i][:, c:c + CHUNK].float() @ ws[j][:, c:c + CHUNK].float().T for i, j in PRODUCTS)
    return y


def refusals(x: torch.Tensor, weight: torch.Tensor) -> list[str]:
    """Why K7 cannot compute ``x weight^T`` in place of ``F.linear``, each
    reason by name, or an empty list: K7 takes contiguous float32 operands
    on the card, a K that is a multiple of ``CHUNK``, and no backward
    (autograd would need one when grad mode is on and ``x`` or ``weight``
    requires grad)."""
    why = []
    if not (x.is_cuda and weight.is_cuda):
        why.append("device")
    if x.dtype != torch.float32 or weight.dtype != torch.float32:
        why.append("dtype")
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad):
        why.append("grad")
    if not (x.is_contiguous() and weight.is_contiguous()):
        why.append("contiguous")
    if weight.dim() != 2 or x.shape[-1] != weight.shape[-1]:
        why.append("shape")
    if x.shape[-1] < CHUNK or x.shape[-1] % CHUNK:
        why.append("k")
    return why


def _version(w: torch.Tensor) -> int:
    """``w``'s version counter; an inference tensor keeps none (-1)."""
    return -1 if w.is_inference() else w._version


class WeightPlanes:
    """K7's ``W`` operand for one or more float32 weights of one K, side by
    side along N (their concatenation's planes at ``BLOCK_N`` tile rows).
    ``of(weights)`` returns them, made on the card the first time and again
    whenever a weight's ``data_ptr``, ``_version`` or shape changes: 6 bytes
    a parameter, held until the next change."""

    def __init__(self):
        self._key: tuple | None = None
        self._planes: torch.Tensor | None = None

    def of(self, weights: tuple[torch.Tensor, ...]) -> torch.Tensor:
        key = tuple((w.data_ptr(), _version(w), tuple(w.shape)) for w in weights)
        if key != self._key:
            self._planes = None  # free the old planes before the new ones are made
            w = weights[0] if len(weights) == 1 else torch.cat(weights)
            self._planes = _planes(w, BLOCK_N)
            self._key = key
        return self._planes


def _planes(x: torch.Tensor, tile_rows: int) -> torch.Tensor:
    """``split_planes_launch`` of a contiguous float32 ``(rows, K)`` on the card."""
    rows, k = x.shape
    out = torch.empty((-(-rows // tile_rows), k // CHUNK, PARTS, tile_rows * CHUNK), dtype=torch.bfloat16,
                      device=x.device)
    launch(_build.entry_point("split_gemm", "split_planes_launch", _SPLIT_ARGTYPES), x, "split_gemm.planes",
           x.data_ptr(), out.data_ptr(), rows, k, tile_rows, rows=rows)
    return out


def split_linear(x: torch.Tensor, weights: tuple[torch.Tensor, ...], planes: WeightPlanes) -> tuple[torch.Tensor, ...]:
    """``x W_i^T`` for each of ``weights`` (all ``(N_i, K)``), as a tuple of
    ``(..., N_i)``. On CUDA tensors one split of ``x`` and one K7 product
    over ``planes.of(weights)``, the outputs views of one ``(..., sum N_i)``
    result; on CPU tensors ``split_gemm_reference`` of each weight. The
    caller checks ``refusals`` first."""
    if not on_card(x, "split_gemm"):
        return tuple(split_gemm_reference(x, w) for w in weights)
    lead, k = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, k)
    m, n = x2.shape[0], sum(w.shape[0] for w in weights)
    b = planes.of(weights)
    a = _planes(x2, BLOCK_M)
    y = x.new_empty((m, n))
    launch(_build.entry_point("split_gemm", "split_gemm_launch", _GEMM_ARGTYPES), x2, "split_gemm",
           a.data_ptr(), b.data_ptr(), y.data_ptr(), m, n, k, rows=m)
    return y.view(*lead, n).split([w.shape[0] for w in weights], dim=-1)
