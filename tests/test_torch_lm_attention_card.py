"""K8 on the card: causal grouped-query attention against float64, float32 SDPA and TF32.

``ops/lm_attention.py::lm_attention`` on CUDA tensors splits q, k and v
into their planes and runs K8. Its error against a float64 attention (its
largest and its mean) is held to that of the route it replaces (K and V
expanded, PyTorch's float32 memory-efficient CUTLASS kernel) on the same
operands, and to a hundredth of the TF32 math route's, at the
voxtral-detect cell's shape (2 clips, 32 query and 8 KV heads of 128,
3,770 positions) and at ragged shapes. The split kernel is
``query_planes`` and ``kv_planes`` bit for bit, and one full-width
``DecoderLayer`` gives the same output on K8's route as on the SDPA route.

Marked ``cuda``: without a card every test skips in its fixture. This file
imports no JAX, which the card machine lacks; ``tests/conftest.py`` does,
so on the card run it without the conftest:

    python3 -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_lm_attention_card.py
"""

import math

import pytest
import torch
import torch.nn.functional as F

from audioanalysisdetector_tpu_torch.models.voxtral import VOXTRAL_MINI_3B, DecoderLayer, rope_tables
from audioanalysisdetector_tpu_torch.ops import launch_counts, reset_launch_counts
from audioanalysisdetector_tpu_torch.ops import lm_attention as k8

D = k8.HEAD_DIM
SDPA_RATIO = 1.0  # K8's errors may be no larger than the SDPA route's
TF32_MARGIN = 100.0  # and must lie this far below the TF32 route's
# a decoder layer's output on the two routes, relative to its largest
# value: the attention within float32 rounding, carried through o and the
# residual adds and the FFN
LAYER_RTOL = 1e-5


@pytest.fixture
def card() -> torch.device:
    """The card with TF32 off, or a skip."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K8 runs on the card only")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _operands(b: int, h: int, hk: int, t: int, seed: int, device) -> tuple[torch.Tensor, ...]:
    """q, k and v as the decoder makes them: head views of one projection."""
    g = torch.Generator(device=device).manual_seed(seed)
    y = torch.randn(b, t, (h + 2 * hk) * D, generator=g, device=device)
    q, k, v = y.split([h * D, hk * D, hk * D], dim=-1)
    return tuple(x.view(b, t, n, D).transpose(1, 2) for x, n in ((q, h), (k, hk), (v, hk)))


def _sdpa(q, k, v) -> torch.Tensor:
    b, h, t, d = q.shape
    g = h // k.shape[1]
    a = F.scaled_dot_product_attention(q, k.repeat_interleave(g, 1), v.repeat_interleave(g, 1), is_causal=True)
    return a.transpose(1, 2).reshape(b, t, h * d)


def _errors(outs: dict, q, k, v) -> dict:
    """The largest and the mean of ``|y - attention|`` for each ``(B, T, H
    d)`` output and for the TF32 math route, against float64, 8 query heads
    at a time."""
    b, h, t, d = q.shape
    group = h // k.shape[1]
    causal = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
    worst, total = dict.fromkeys((*outs, "tf32"), 0.0), dict.fromkeys((*outs, "tf32"), 0.0)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        for h0 in range(0, h, 8):
            heads = torch.arange(h0, min(h0 + 8, h), device=q.device)
            qq, kk, vv = q[:, heads], k[:, heads // group], v[:, heads // group]
            want = F.scaled_dot_product_attention(qq.double(), kk.double(), vv.double(), is_causal=True)
            s = (qq @ kk.transpose(-1, -2)).mul_(d ** -0.5).masked_fill_(~causal, -math.inf)
            got = {name: y.view(b, t, h, d).transpose(1, 2)[:, heads] for name, y in outs.items()}
            got["tf32"] = torch.softmax(s, dim=-1) @ vv
            del s
            for name, y in got.items():
                err = (y.double() - want).abs_()
                worst[name] = max(worst[name], float(err.max()))
                total[name] += float(err.sum())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    return {name: (worst[name], total[name] / q.numel()) for name in worst}


@pytest.mark.cuda
@pytest.mark.parametrize("b, h, hk, t, tf32", [(2, 32, 8, 3770, True), (1, 32, 8, 1, False), (2, 32, 8, 37, True),
                                               (1, 8, 8, 130, False), (2, 32, 8, 257, True), (1, 32, 8, 1000, True)],
                         ids=["cell", "t1", "t37", "group1-t130", "t257", "t1000"])
def test_k8_error_against_float64(card, b, h, hk, t, tf32):
    """K8 at the cell's shape and at ragged ones: one attention launch and
    one split, its errors no larger than the SDPA route's, and a hundredth
    of TF32's where cuBLAS runs the TF32 route's products in TF32 (not at
    one position, where the softmax is 1, nor for 8 heads of 130, whose
    batched products cuBLAS keeps in fp32: an H100 read 1.4e-6 there)."""
    q, k, v = _operands(b, h, hk, t, seed=b + h + hk + t, device=card)
    with torch.inference_mode():
        reset_launch_counts()
        got = k8.lm_attention(q, k, v)
        torch.cuda.synchronize()
        counts = launch_counts()
        err = _errors({"k8": got, "sdpa": _sdpa(q, k, v)}, q, k, v)
    assert counts["lm_attention"] == 1 and counts["lm_attention.planes"] == 1 and sum(counts.values()) == 2
    assert all(e <= SDPA_RATIO * s for e, s in zip(err["k8"], err["sdpa"])), err
    if tf32:
        assert all(TF32_MARGIN * e <= x for e, x in zip(err["k8"], err["tf32"])), err


@pytest.mark.cuda
@pytest.mark.parametrize("b, h, hk, t", [(1, 8, 2, 100), (2, 32, 8, 257), (1, 4, 4, 70), (2, 32, 8, 3770)])
def test_split_kernel_is_the_plain_layout(card, b, h, hk, t):
    """The split kernel writes ``query_planes``' and ``kv_planes``' bits,
    padding rows and all, from the decoder's strided views, including values
    whose parts reach bf16's subnormals."""
    q, k, v = _operands(b, h, hk, t, seed=t, device=card)
    q[0, 0, 0, :64] = torch.tensor([1e-40, -3e-39, 2.0**-120, 1e38] * 16, device=card)
    with torch.inference_mode():
        got_q, got_kv = k8.planes(q, k, v)
        assert torch.equal(got_q, k8.query_planes(q, hk)) and torch.equal(got_kv, k8.kv_planes(k, v))


@pytest.mark.cuda
def test_decoder_layer_routes(card, monkeypatch):
    """One full-width decoder layer over the cell's 2 x 3,770 positions:
    one K8 launch, and the same output as on the SDPA route (``refusals``
    made to refuse) within float32 rounding; no K8 launch under grad mode."""
    torch.manual_seed(0)
    layer = DecoderLayer(VOXTRAL_MINI_3B).to(card).eval()
    for lin in (layer.q, layer.k, layer.v, layer.o, layer.gate, layer.up, layer.down):
        torch.nn.init.normal_(lin.weight, 0.0, 0.02)  # the benchmark's draw
    h = torch.randn(2, 3770, VOXTRAL_MINI_3B.hidden, device=card)
    cos, sin = rope_tables(3770, D, VOXTRAL_MINI_3B.rope_theta, card, h.dtype)
    with torch.inference_mode():
        reset_launch_counts()
        got = layer(h, cos, sin)
        torch.cuda.synchronize()
        assert launch_counts()["lm_attention"] == 1 and launch_counts()["lm_attention.planes"] == 1
        with monkeypatch.context() as patch:
            patch.setattr(k8, "refusals", lambda q, k, v: ["forced"])
            reset_launch_counts()
            want = layer(h, cos, sin)
            torch.cuda.synchronize()
            assert launch_counts()["lm_attention"] == 0
    assert float((got - want).abs().max()) <= LAYER_RTOL * float(want.abs().max())
    reset_launch_counts()
    layer(h[:, :64], cos[:64], sin[:64]).sum().backward()  # grad mode: SDPA and its gradients
    assert launch_counts()["lm_attention"] == 0 and layer.q.weight.grad is not None
