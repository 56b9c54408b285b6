"""K8 (``ops/lm_attention.py``, ``ops/csrc/lm_attention.cu``) on the CPU.

The kernel cannot run here, so its arithmetic and its plumbing are held
apart: ``lm_attention_reference`` (tiles of 64 positions, three-way splits,
six part products a chunk, the online softmax) stands as close to a float64
attention as float32 SDPA does, and is causal bit for bit; ``query_planes``
and ``kv_planes`` (the plain version of the split kernel) put each part
where the kernel reads it; ``refusals`` names each reason K8 cannot run.
The launch path is driven on CPU tensors by fake C entry points that do
what the two kernels do through the tensors' own memory
(``emulated_card``): the split writes the plain layouts' bits, the
attention decodes the planes and computes ``attention_from_parts``. With
them the decoder layer's K8 route runs here end to end. ``lm_attend`` on
CPU tensors keeps the expansion and SDPA, bit for bit.
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
from audioanalysisdetector_tpu_torch.models.voxtral import DecoderLayer, VoxtralConfig, lm_attend, rope_tables
from audioanalysisdetector_tpu_torch.ops import lm_attention as k8

STREAM = 0x5EED
D = k8.HEAD_DIM
# a decoder layer with the kernel's head size and 4 query heads a KV head
TINY = VoxtralConfig(hidden=256, heads=8, kv_heads=2, head_dim=D, ffn=384, layers=1, vocab=2000)


def _gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def _operands(b: int, h: int, hk: int, t: int, seed: int) -> tuple[torch.Tensor, ...]:
    """q, k and v as the decoder makes them: head views of one projection."""
    y = torch.randn(b, t, (h + 2 * hk) * D, generator=_gen(seed))
    q, k, v = y.split([h * D, hk * D, hk * D], dim=-1)
    return tuple(x.view(b, t, n, D).transpose(1, 2) for x, n in ((q, h), (k, hk), (v, hk)))


def _sdpa(q, k, v) -> torch.Tensor:
    """The expansion + SDPA route of ``lm_attend``, as ``(B, T, H d)``."""
    b, h, t, d = q.shape
    g = h // k.shape[1]
    a = F.scaled_dot_product_attention(q, k.repeat_interleave(g, 1), v.repeat_interleave(g, 1), is_causal=True)
    return a.transpose(1, 2).reshape(b, t, h * d)


@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("t", [1, 37, 130, 257])
def test_reference_is_as_close_to_float64_as_float32_sdpa(t, group):
    """At one position, ragged tiles and across the diagonal, for groups of
    1 and 4 query heads a KV head: the reference's largest and mean errors
    against float64 attention are no worse than float32 SDPA's on the same
    operands, and within a few float32 roundings of the output's size."""
    q, k, v = _operands(2, 2 * group, 2, t, seed=t + group)
    want = _sdpa(q.double(), k.double(), v.double())

    def errors(y):
        err = (y.double() - want).abs()
        return float(err.max()), float(err.mean())

    got, sdpa = errors(k8.lm_attention_reference(q, k, v)), errors(_sdpa(q, k, v))
    assert got[0] <= sdpa[0] and got[1] <= sdpa[1], (got, sdpa)
    assert got[0] <= 8 * 2.0**-24 * float(want.abs().max())


@pytest.mark.parametrize("cut", [1, 63, 64, 100])
def test_reference_is_causal_bit_for_bit(cut):
    """Changing q, k and v at positions ``cut`` and later leaves every
    output before ``cut`` bit for bit the same."""
    q, k, v = _operands(1, 8, 2, 130, seed=11)
    before = k8.lm_attention_reference(q, k, v)
    q2, k2, v2 = (x.clone() for x in (q, k, v))
    for x in (q2, k2, v2):
        x[:, :, cut:] = torch.randn(x[:, :, cut:].shape, generator=_gen(cut)) * 3.0
    after = k8.lm_attention_reference(q2, k2, v2)
    assert torch.equal(after[:, :cut], before[:, :cut])
    assert not torch.equal(after[:, cut:], before[:, cut:])


@pytest.mark.parametrize("heads, kv_heads, t", [(8, 2, 100), (4, 4, 130), (32, 2, 37)])
def test_query_planes_put_each_part_where_the_kernel_reads_it(heads, kv_heads, t):
    """Part p of element (b, head, position, d) lies in q tile ``position //
    P`` of KV head ``head // G``, depth chunk ``d // 32``, at row ``r = 64
    w + (head % G) (64 / G) + position % (64 / G)`` with ``w = position % P
    // (P / 2)``, offset ``((r // 8) 4 + d % 32 // 8) 64 + (r % 8) 8 + d %
    8``; positions past T are zero."""
    q, _, _ = _operands(2, heads, kv_heads, t, seed=3)
    planes = k8.query_planes(q, kv_heads)
    group, span = heads // kv_heads, k8.positions_a_tile(heads, kv_heads)
    tiles = -(-t // span)
    assert planes.shape == (2, kv_heads, tiles, D // k8.CHUNK, k8.PARTS, k8.ROWS * k8.CHUNK)
    assert planes.dtype == torch.bfloat16
    b, h, pos, d = (torch.from_numpy(a) for a in np.meshgrid(np.arange(2), np.arange(heads), np.arange(t),
                                                             np.arange(D), indexing="ij"))
    r = 64 * (pos % span // (span // 2)) + (h % group) * (64 // group) + pos % (64 // group)
    offset = ((r // 8) * 4 + d % 32 // 8) * 64 + (r % 8) * 8 + d % 8
    for p, part in enumerate(k8.split3(q)):
        assert torch.equal(planes[b, h // group, pos // span, d // 32, p, offset], part)
    written = torch.zeros_like(planes, dtype=torch.bool)
    for p in range(k8.PARTS):
        written[b, h // group, pos // span, d // 32, p, offset] = True
    assert written.sum() == k8.PARTS * q.numel() and not planes[~written].any()


def test_kv_planes_put_each_part_where_the_kernel_reads_it():
    """K's part p of (b, g, position, d): tile ``position // 64``, item ``d
    // 64``, at ``((d % 64 // 32) 3 + p) 2048 + ((r // 8) 4 + d % 32 // 8) 64
    + (r % 8) 8 + d % 8`` with ``r = position % 64``; V's, transposed: item
    ``2 + r // 32``, at ``p 4096 + ((d // 8) 4 + r % 32 // 8) 64 + (d % 8) 8 +
    r % 8``; the positions past T zero."""
    _, k, v = _operands(2, 4, 2, 150, seed=4)
    planes = k8.kv_planes(k, v)
    assert planes.shape == (2, 2, 3, 4, k8.ITEM) and planes.dtype == torch.bfloat16
    b, g, pos, d = (torch.from_numpy(a) for a in np.meshgrid(np.arange(2), np.arange(2), np.arange(150),
                                                             np.arange(D), indexing="ij"))
    r = pos % 64
    written = torch.zeros_like(planes, dtype=torch.bool)
    for p, (kp, vp) in enumerate(zip(k8.split3(k), k8.split3(v))):
        k_at = (((d % 64 // 32) * 3 + p) * 2048 + ((r // 8) * 4 + d % 32 // 8) * 64 + (r % 8) * 8 + d % 8)
        v_at = p * 4096 + ((d // 8) * 4 + r % 32 // 8) * 64 + (d % 8) * 8 + r % 8
        assert torch.equal(planes[b, g, pos // 64, d // 64, k_at], kp)
        assert torch.equal(planes[b, g, pos // 64, 2 + r // 32, v_at], vp)
        written[b, g, pos // 64, d // 64, k_at] = True
        written[b, g, pos // 64, 2 + r // 32, v_at] = True
    assert not planes[~written].any()


def test_refusals_name_each_reason():
    """K8 takes float32 operands on the card, no backward, ``(B, H, T, 128)``
    against ``(B, H_kv, T, 128)`` with a group among ``GROUPS``, and strides
    it can read: each departure is named."""
    q, k, v = _operands(1, 8, 2, 20, seed=5)
    assert k8.refusals(q, k, v) == ["device"]  # the CPU: the expansion and SDPA
    assert k8.refusals(q.double(), k, v) == ["device", "dtype"]
    assert k8.refusals(q, k.detach().requires_grad_(), v) == ["device", "grad"]
    with torch.no_grad():
        assert k8.refusals(q, k.detach().requires_grad_(), v) == ["device"]
    assert k8.refusals(q, k[:, :, :10], v[:, :, :10]) == ["device", "shape"]
    assert k8.refusals(q[..., :64], k[..., :64], v[..., :64]) == ["device", "head_dim"]
    q3, k3, v3 = _operands(1, 6, 2, 20, seed=6)
    assert k8.refusals(q3, k3, v3) == ["device", "group"]
    assert k8.refusals(q.transpose(2, 3).contiguous().transpose(2, 3), k, v) == ["device", "strides"]
    assert k8.refusals(q, k[..., 1:].contiguous()[..., :1].expand(-1, -1, -1, D), v) == ["device", "strides"]


def test_lm_attend_on_the_cpu_is_unchanged():
    """On CPU tensors ``lm_attend`` is the expansion and SDPA, bit for bit,
    and launches nothing."""
    q, k, v = _operands(2, 8, 2, 45, seed=7)
    ops.reset_launch_counts()
    assert torch.equal(lm_attend(q, k, v), _sdpa(q, k, v))
    assert set(ops.launch_counts().values()) == {0}


def _memory(ptr: int, dtype: torch.dtype, count: int) -> torch.Tensor:
    """A flat CPU tensor over ``count`` elements at the address ``ptr``."""
    np_dtype = {torch.float32: np.float32, torch.bfloat16: np.uint16}[dtype]
    buf = (ctypes.c_byte * (count * np.dtype(np_dtype).itemsize)).from_address(ptr)
    t = torch.from_numpy(np.frombuffer(buf, dtype=np_dtype))
    return t.view(torch.bfloat16) if dtype == torch.bfloat16 else t


def _strided(ptr: int, shape: tuple, strides: tuple) -> torch.Tensor:
    extent = 1 + sum((n - 1) * s for n, s in zip(shape, strides))
    return _memory(ptr, torch.float32, extent).as_strided(shape, strides)


def _uncore(x: torch.Tensor, rows: int) -> torch.Tensor:
    """``_core`` undone: ``(..., K / CHUNK, rows CHUNK)`` -> ``(..., rows, K)``."""
    *lead, chunks, _ = x.shape
    n = len(lead)
    y = x.reshape(*lead, chunks, rows // 8, k8.CHUNK // 8, 8, 8)
    return y.permute(*range(n), n + 1, n + 3, n, n + 2, n + 4).reshape(*lead, rows, chunks * k8.CHUNK)


def _parts_of_planes(qp: torch.Tensor, kvp: torch.Tensor, heads: int, t: int):
    """The three parts of q ``(B, H, T, d)`` and of k and v ``(B, H_kv, T,
    d)`` that ``query_planes`` and ``kv_planes`` laid out."""
    b, hk, q_tiles = qp.shape[:3]
    group, span = heads // hk, k8.positions_a_tile(heads, hk)
    q = _uncore(qp.transpose(3, 4), k8.ROWS)  # (B, H_kv, tiles, part, ROWS, d)
    q = q.view(b, hk, q_tiles, k8.PARTS, 2, group, span // 2, D).permute(3, 0, 1, 5, 2, 4, 6, 7)
    q = q.reshape(k8.PARTS, b, heads, q_tiles * span, D)[:, :, :, :t]
    tiles = kvp.shape[2]
    kk = kvp[:, :, :, :2].reshape(b, hk, tiles, 2, 2, k8.PARTS, 64 * k8.CHUNK).permute(5, 0, 1, 2, 3, 4, 6)
    kk = _uncore(kk.reshape(k8.PARTS, b, hk, tiles, 4, 64 * k8.CHUNK), 64).reshape(k8.PARTS, b, hk, -1, D)[..., :t, :]
    vv = kvp[:, :, :, 2:].reshape(b, hk, tiles, 2, k8.PARTS, D * k8.CHUNK).permute(4, 0, 1, 2, 3, 5)
    vv = _uncore(vv, D).transpose(-1, -2).reshape(k8.PARTS, b, hk, -1, D)[..., :t, :]
    return tuple(q), tuple(kk), tuple(vv)


class EmulatedCard:
    """The two C entry points, done on CPU tensors through their memory:
    ``lm_planes_launch`` writes ``query_planes`` and ``kv_planes``'s bits,
    and ``lm_attention_launch`` decodes the planes and writes
    ``attention_from_parts``. Each records its arguments."""

    def __init__(self):
        self.calls = []

    def entry(self, source: str, symbol: str, argtypes: tuple):
        assert source == "lm_attention"
        return getattr(self, symbol)

    def lm_planes_launch(self, q, k, v, qp, kvp, b, h, hk, t, *rest):
        strides, stream = rest[:9], rest[9]
        self.calls.append(("planes", b, h, hk, t, strides, stream))
        qt, kt, vt = (_strided(p, (b, n, t, D), (*strides[3 * i:3 * i + 3], 1))
                      for i, (p, n) in enumerate(((q, h), (k, hk), (v, hk))))
        for ptr, planes in ((qp, k8.query_planes(qt, hk)), (kvp, k8.kv_planes(kt, vt))):
            _memory(ptr, torch.bfloat16, planes.numel()).copy_(planes.flatten())
        return 0

    def lm_attention_launch(self, qp, kvp, out, b, h, hk, t, stream):
        self.calls.append(("attention", b, h, hk, t, stream))
        q_tiles, kv_tiles = -(-t // k8.positions_a_tile(h, hk)), -(-t // k8.BLOCK_KV)
        q_shape = (b, hk, q_tiles, D // k8.CHUNK, k8.PARTS, k8.ROWS * k8.CHUNK)
        kv_shape = (b, hk, kv_tiles, 4, k8.ITEM)
        q_planes = _memory(qp, torch.bfloat16, math.prod(q_shape)).view(q_shape)
        kv_planes = _memory(kvp, torch.bfloat16, math.prod(kv_shape)).view(kv_shape)
        got = k8.attention_from_parts(*_parts_of_planes(q_planes, kv_planes, h, t))
        _memory(out, torch.float32, got.numel()).copy_(got.flatten())
        return 0


@pytest.fixture
def emulated_card(monkeypatch):
    """K8's route without a card: the tensors stay on the CPU, ``refusals``
    finds nothing, the wrapper takes them for card tensors, and the entry
    points are ``EmulatedCard``'s."""
    card = EmulatedCard()
    monkeypatch.setattr(k8, "refusals", lambda q, k, v: [])
    monkeypatch.setattr(k8, "on_card", lambda x, kernel: True)
    monkeypatch.setattr(k8._build, "entry_point", card.entry)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: SimpleNamespace(cuda_stream=STREAM))
    ops.reset_launch_counts()
    yield card
    ops.reset_launch_counts()


@pytest.mark.parametrize("heads, kv_heads, t", [(8, 2, 37), (4, 4, 130), (16, 1, 70)])
def test_the_planes_carry_the_reference(emulated_card, heads, kv_heads, t):
    """Through the emulated card, strided operands give
    ``lm_attention_reference`` bit for bit: one split, one attention, the
    strides passed in elements."""
    q, k, v = _operands(2, heads, kv_heads, t, seed=t)
    got = k8.lm_attention(q, k, v)
    assert got.shape == (2, t, heads * D)
    assert torch.equal(got, k8.lm_attention_reference(q, k, v))
    assert emulated_card.calls == [
        ("planes", 2, heads, kv_heads, t, (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3]), STREAM),
        ("attention", 2, heads, kv_heads, t, STREAM)]
    assert ops.launch_counts() == {**dict.fromkeys(ops.LAUNCH_COUNTERS, 0), "lm_attention": 1,
                                   "lm_attention.planes": 1}


def test_decoder_layer_routes_through_k8(emulated_card):
    """The decoder layer on K8's route: one attention launch and one split a
    layer, ``(B, T, H d)`` into the o projection, the layer's output within
    float32 rounding of the expansion + SDPA route's."""
    torch.manual_seed(8)
    layer = DecoderLayer(TINY).eval()
    h = torch.randn(2, 70, TINY.hidden, generator=_gen(8))
    cos, sin = rope_tables(70, D, TINY.rope_theta, h.device, h.dtype)
    seen = []
    o_forward = layer.o.forward
    layer.o.forward = lambda x: seen.append(tuple(x.shape)) or o_forward(x)
    with torch.no_grad():
        got = layer(h, cos, sin)
    assert ops.launch_counts()["lm_attention"] == 1 and ops.launch_counts()["lm_attention.planes"] == 1
    assert seen == [(2, 70, TINY.heads * D)]
    assert [c[0] for c in emulated_card.calls] == ["planes", "attention"]
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(k8, "refusals", lambda q, k, v: ["forced"])
        ops.reset_launch_counts()
        with torch.no_grad():
            want = layer(h, cos, sin)
        assert set(ops.launch_counts().values()) == {0}
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
