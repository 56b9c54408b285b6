"""K7 (``ops/split_gemm.py``, ``ops/csrc/split_gemm.cu``) on the CPU.

The kernel cannot run here, so its arithmetic and its plumbing are held
apart: ``split3``'s three bf16 parts sum to the float32 input exactly;
``plane_layout`` (the plain version of the split kernel) puts each part in
the wgmma core-matrix layout the product reads; ``split_gemm_reference``
(the six part products, chunk by chunk) is as close to a float64 product as
a float32 product is; ``refusals`` names each reason K7 cannot run. The
launch path is driven on CPU tensors by fake C entry points that do what
the two kernels do through the tensors' own memory (``emulated_card``): the
split writes ``plane_layout``'s bits, the product decodes the planes and
computes ``products``. With them the decoder layer's K7 route runs here end
to end, side-by-side weights, padding, weight caching and counters
included. ``DecoderLayer`` on CPU tensors keeps ``F.linear``, bit for bit.
"""

import contextlib
import ctypes
import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from audioanalysisdetector_tpu_torch import ops
from audioanalysisdetector_tpu_torch.models.voxtral import DecoderLayer, VoxtralConfig, apply_rope, lm_attend, rope_tables
from audioanalysisdetector_tpu_torch.models.wav2vec2 import split_heads
from audioanalysisdetector_tpu_torch.ops import split_gemm as k7

STREAM = 0x5EED
# a tiny decoder layer: q|k|v is 96 + 2 x 32 = 160 columns, short of one
# BLOCK_N tile, gate|up 2 x 96 one whole tile, K = 64 and 96 two and three chunks
TINY = VoxtralConfig(hidden=64, heads=6, kv_heads=2, head_dim=16, ffn=96, layers=1, vocab=2000)


def _gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def _exact_sum(parts) -> torch.Tensor:
    return sum(p.double() for p in parts)


def test_split3_parts_sum_exactly():
    """The three parts sum to the input exactly over N(0, 0.02) draws,
    unit normals, every binade from 2**-110 to 2**127 (random bit patterns
    below bf16's largest value), powers of two and +-0; below 2**-110,
    float32's subnormals included, to within 2**-134, half of bf16's
    smallest subnormal."""
    g = _gen(1)
    bits = torch.randint(0, 2**31 - 1, (200_000,), generator=g, dtype=torch.int64).to(torch.int32)
    wide = bits.view(torch.float32)
    wide = wide[torch.isfinite(wide) & (wide.abs() < 3.38e38)]
    x = torch.cat([
        torch.randn(100_000, generator=g) * 0.02, torch.randn(100_000, generator=g), wide, -wide,
        torch.tensor([0.0, -0.0, 2.0**-110, 2.0**127, 1e38, -1e38, 3.38e38, 1.0, -1.0, 2.0**-126]),
    ])
    parts = k7.split3(x)
    assert all(p.dtype == torch.bfloat16 for p in parts)
    normal = x.abs() >= 2.0**-110
    assert normal.sum() > 300_000
    assert torch.equal(_exact_sum(parts)[normal], x.double()[normal])
    tiny = torch.cat([
        torch.tensor([1e-45, -1e-45, 1.4e-45, 5.9e-39, 1.1754942e-38, 2.0**-127, 2.0**-133, 3e-40]),
        wide[wide.abs() < 2.0**-110][:1000],
    ])
    assert (tiny.abs() < 2.0**-126).any()  # float32 subnormals are among them
    assert float((_exact_sum(k7.split3(tiny)) - tiny.double()).abs().max()) <= 2.0**-134
    # each part is what the ones before leave, rounded: |mid| <= 2^-8 |x|, |lo| <= 2^-8 |mid|
    hi, mid, lo = (p.double()[normal] for p in parts)
    assert bool((mid.abs() <= 2.0**-8 * x.double()[normal].abs()).all())
    assert bool((lo.abs() <= 2.0**-8 * mid.abs()).all())


@pytest.mark.parametrize("tile_rows", [k7.BLOCK_M, k7.BLOCK_N])
def test_plane_layout_puts_each_part_in_core_matrices(tile_rows):
    """Element (row r, column k) of part p lies in block (r // R, k //
    CHUNK), at core matrix (r % R // 8, k % CHUNK // 8), row r % 8, column k
    % 8 of it: offset ((r % R // 8) * CHUNK / 8 + k % CHUNK // 8) * 64 + (r %
    8) * 8 + k % 8. The rows past the matrix are zero."""
    rows, k = tile_rows + 37, 3 * k7.CHUNK
    x = torch.randn(rows, k, generator=_gen(2))
    planes = k7.plane_layout(x, tile_rows)
    assert planes.shape == (2, 3, k7.PARTS, tile_rows * k7.CHUNK) and planes.dtype == torch.bfloat16
    parts = k7.split3(x)
    r, c = np.meshgrid(np.arange(rows), np.arange(k), indexing="ij")
    rr, kk = r % tile_rows, c % k7.CHUNK
    offset = ((rr // 8) * (k7.CHUNK // 8) + kk // 8) * 64 + (rr % 8) * 8 + kk % 8
    for p in range(k7.PARTS):
        got = planes[r // tile_rows, c // k7.CHUNK, p, offset]
        assert torch.equal(got, parts[p])
    assert not planes[1, :, :].view(3, k7.PARTS, tile_rows // 8, k7.CHUNK // 8, 8, 8)[
        :, :, (rows - tile_rows + 7) // 8:].any()


@pytest.mark.parametrize("k", [3072, 4096, 8192])
def test_reference_is_as_close_to_float64_as_float32(k):
    """At the decoder's K, the six part products chunk by chunk stand as
    close to a float64 product, relative to sum |x| |w|, as a float32
    product does: their largest and mean errors within twice the float32
    matmul's on the same operands, and within a few float32 roundings."""
    g = _gen(k)
    x = torch.randn(24, k, generator=g)
    w = torch.randn(40, k, generator=g) * 0.02
    want = x.double() @ w.double().T
    scale = x.double().abs() @ w.double().abs().T

    def errors(y):
        rel = (y.double() - want).abs() / scale
        return float(rel.max()), float(rel.mean())

    got, fp32 = errors(k7.split_gemm_reference(x, w)), errors(x @ w.T)
    assert got[0] <= 2 * fp32[0] and got[1] <= 2 * fp32[1]
    assert got[0] < 8 * 2.0**-24


def test_refusals_name_each_reason():
    """K7 takes contiguous float32 operands on the card, K a multiple of
    CHUNK, and no backward: each departure is named."""
    x = torch.randn(5, 64)
    w = torch.randn(32, 64)
    assert k7.refusals(x, w) == ["device"]  # the CPU: F.linear
    assert k7.refusals(x.double(), w) == ["device", "dtype"]
    assert k7.refusals(x, w.requires_grad_()) == ["device", "grad"]
    with torch.no_grad():
        assert k7.refusals(x, w) == ["device"]  # no backward can be asked under no_grad
    w = w.detach()
    assert k7.refusals(x.t().contiguous().t(), w) == ["device", "contiguous"]
    assert k7.refusals(x, torch.randn(32, 96)) == ["device", "shape"]
    assert k7.refusals(torch.randn(5, 48), torch.randn(32, 48)) == ["device", "k"]
    assert k7.refusals(torch.randn(5, 16), torch.randn(32, 16)) == ["device", "k"]


def _old_forward(layer: DecoderLayer, h, cos, sin):
    """The decoder layer's equations as ``nn.Linear`` computes each projection."""
    x = layer.attn_norm(h)
    q = apply_rope(split_heads(layer.q(x), layer.heads), cos, sin)
    k = apply_rope(split_heads(layer.k(x), layer.kv_heads), cos, sin)
    h = h + layer.o(lm_attend(q, k, split_heads(layer.v(x), layer.kv_heads)))
    x = layer.ffn_norm(h)
    return h + layer.down(F.silu(layer.gate(x)) * layer.up(x))


def _layer_inputs(seed: int, t: int = 21):
    torch.manual_seed(seed)
    layer = DecoderLayer(TINY).eval()
    h = torch.randn(2, t, TINY.hidden, generator=_gen(seed))
    cos, sin = rope_tables(t, TINY.head_dim, TINY.rope_theta, h.device, h.dtype)
    return layer, h, cos, sin


def test_decoder_layer_on_the_cpu_keeps_f_linear(monkeypatch):
    """On CPU tensors each of the seven projections is one ``F.linear``
    call and the layer's output is the old equations' bit for bit; no
    kernel launch is counted."""
    layer, h, cos, sin = _layer_inputs(3)
    calls = []
    linear = F.linear
    monkeypatch.setattr(torch.nn.modules.linear.F, "linear", lambda *a: calls.append(a[1].shape) or linear(*a))
    ops.reset_launch_counts()
    with torch.inference_mode():
        got = layer(h, cos, sin)
        n = len(calls)
        want = _old_forward(layer, h, cos, sin)
    assert n == 7
    assert torch.equal(got, want)
    assert set(ops.launch_counts().values()) == {0}


def _memory(ptr: int, dtype: torch.dtype, count: int) -> torch.Tensor:
    """A CPU tensor over ``count`` elements at the address ``ptr``."""
    np_dtype = {torch.float32: np.float32, torch.bfloat16: np.uint16}[dtype]
    buf = (ctypes.c_byte * (count * np.dtype(np_dtype).itemsize)).from_address(ptr)
    t = torch.from_numpy(np.frombuffer(buf, dtype=np_dtype))
    return t.view(torch.bfloat16) if dtype == torch.bfloat16 else t


def _unlayout(planes: torch.Tensor, rows: int) -> tuple[torch.Tensor, ...]:
    """``plane_layout`` undone: the three ``(rows, K)`` parts."""
    tiles, chunks, parts, n = planes.shape
    r = n // k7.CHUNK
    p = planes.view(tiles, chunks, parts, r // 8, k7.CHUNK // 8, 8, 8).permute(2, 0, 3, 5, 1, 4, 6)
    return tuple(p.reshape(parts, tiles * r, chunks * k7.CHUNK)[:, :rows])


class EmulatedCard:
    """The two C entry points, done on CPU tensors through their memory:
    ``split_planes_launch`` writes ``plane_layout``'s bits, and
    ``split_gemm_launch`` decodes both operands' planes and writes
    ``products``. Each records its arguments."""

    def __init__(self):
        self.calls = []

    def entry(self, source: str, symbol: str, argtypes: tuple):
        assert source == "split_gemm"
        return getattr(self, symbol)

    def split_planes_launch(self, x, out, rows, k, tile_rows, stream):
        self.calls.append(("split", rows, k, tile_rows, stream))
        src = _memory(x, torch.float32, rows * k).view(rows, k)
        planes = k7.plane_layout(src, tile_rows)
        _memory(out, torch.bfloat16, planes.numel()).copy_(planes.flatten())
        return 0

    def split_gemm_launch(self, a, b, y, m, n, k, stream):
        self.calls.append(("gemm", m, n, k, stream))
        chunks = k // k7.CHUNK
        shape = lambda rows, tile: (-(-rows // tile), chunks, k7.PARTS, tile * k7.CHUNK)  # noqa: E731
        a_planes = _memory(a, torch.bfloat16, math.prod(shape(m, k7.BLOCK_M))).view(shape(m, k7.BLOCK_M))
        b_planes = _memory(b, torch.bfloat16, math.prod(shape(n, k7.BLOCK_N))).view(shape(n, k7.BLOCK_N))
        out = k7.products(_unlayout(a_planes, m), _unlayout(b_planes, n))
        _memory(y, torch.float32, m * n).copy_(out.flatten())
        return 0


@pytest.fixture
def emulated_card(monkeypatch):
    """K7's route without a card: the tensors stay on the CPU, ``refusals``
    finds nothing, the wrapper takes them for card tensors, and the entry
    points are ``EmulatedCard``'s."""
    card = EmulatedCard()
    monkeypatch.setattr(k7, "refusals", lambda x, w: [])
    monkeypatch.setattr(k7, "on_card", lambda x, kernel: True)
    monkeypatch.setattr(k7._build, "entry_point", card.entry)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: SimpleNamespace(cuda_stream=STREAM))
    ops.reset_launch_counts()
    yield card
    ops.reset_launch_counts()


def test_split_linear_side_by_side_is_each_alone(emulated_card):
    """Weights side by side (q|k|v, 160 columns: padded to one BLOCK_N
    tile) give each weight's ``split_gemm_reference`` bit for bit, over a
    ragged M (42 rows of a 128-row tile); one split of x, one of the
    weights together, one product."""
    g = _gen(5)
    x = torch.randn(2, 21, 64, generator=g)
    ws = tuple(torch.randn(n, 64, generator=g) * 0.02 for n in (96, 32, 32))
    outs = k7.split_linear(x, ws, k7.WeightPlanes())
    assert [o.shape for o in outs] == [(2, 21, 96), (2, 21, 32), (2, 21, 32)]
    for o, w in zip(outs, ws):
        assert torch.equal(o, k7.split_gemm_reference(x, w))
    assert emulated_card.calls == [("split", 160, 64, k7.BLOCK_N, STREAM), ("split", 42, 64, k7.BLOCK_M, STREAM),
                                   ("gemm", 42, 160, 64, STREAM)]
    assert ops.launch_counts() == {**dict.fromkeys(ops.LAUNCH_COUNTERS, 0), "split_gemm": 1, "split_gemm.planes": 2}


def test_decoder_layer_k7_route(emulated_card):
    """The decoder layer on K7's route: four launches a call (q|k|v, o,
    gate|up, down), each projection K7's arithmetic, the output within
    float32 rounding of ``F.linear``'s; the weights' planes made at the
    first call only, and made again for q|k|v alone once q's weight changes
    in place."""
    layer, h, cos, sin = _layer_inputs(7)
    with torch.inference_mode():
        want = _old_forward(layer, h, cos, sin)
    with torch.no_grad():
        got = layer(h, cos, sin)
        assert ops.launch_counts()["split_gemm"] == 4 and ops.launch_counts()["split_gemm.planes"] == 8
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
        ops.reset_launch_counts()
        again = layer(h, cos, sin)
        assert torch.equal(again, got)
        assert ops.launch_counts()["split_gemm"] == 4 and ops.launch_counts()["split_gemm.planes"] == 4
        layer.q.weight.mul_(1.0)  # in place: the version moves, the values do not
        ops.reset_launch_counts()
        assert torch.equal(layer(h, cos, sin), got)
        assert ops.launch_counts()["split_gemm.planes"] == 5
    gemms = [c[1:4] for c in emulated_card.calls if c[0] == "gemm"]
    assert gemms[:4] == [(42, 160, 64), (42, 64, 96), (42, 192, 64), (42, 64, 96)]



def test_weight_planes_follow_their_weights(emulated_card):
    """A weight's planes are made once, made again when the weight changes
    in place (its version) or is replaced (another ``data_ptr``), and an
    inference tensor, which keeps no version counter, is taken as well."""
    planes = k7.WeightPlanes()
    w = torch.randn(32, 64, generator=_gen(9))
    first = planes.of((w,))
    assert planes.of((w,)) is first and torch.equal(first, k7.plane_layout(w, k7.BLOCK_N))
    w.add_(1.0)
    second = planes.of((w,))
    assert second is not first and torch.equal(second, k7.plane_layout(w, k7.BLOCK_N))
    with torch.inference_mode():
        frozen = torch.randn(32, 64, generator=_gen(10))
    third = planes.of((frozen,))
    assert planes.of((frozen,)) is third and torch.equal(third, k7.plane_layout(frozen, k7.BLOCK_N))
    assert ops.launch_counts()["split_gemm.planes"] == 3
