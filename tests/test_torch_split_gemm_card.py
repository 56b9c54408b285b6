"""K7 on the card: float32 products on the tensor cores against float64, cuBLAS's float32 and TF32.

``ops/split_gemm.py::split_linear`` on CUDA tensors splits x into its
planes and runs K7's product over a weight's cached planes. Its error
against a float64 product, relative to ``sum |x| |w|``, is held to twice
that of ``torch.matmul`` in float32 with TF32 off on the same operands (its
largest and its mean), and to a hundredth of TF32's, at the seven decoder
projections of the voxtral-detect cell (M = B T = 2 x 3,770) and at ragged
M. The split kernel is ``plane_layout`` bit for bit, and one full-width
``DecoderLayer`` gives the same output on K7's route as on ``F.linear``'s.

Marked ``cuda``: without a card every test skips in its fixture. This file
imports no JAX, which the card machine lacks; ``tests/conftest.py`` does,
so on the card run it without the conftest:

    python3 -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_split_gemm_card.py
"""

import pytest
import torch

from audioanalysisdetector_tpu_torch.models.voxtral import VOXTRAL_MINI_3B, DecoderLayer, rope_tables
from audioanalysisdetector_tpu_torch.ops import launch_counts, reset_launch_counts
from audioanalysisdetector_tpu_torch.ops import split_gemm as k7

M = 2 * 3770  # the decoder's positions a call in the voxtral-detect cell
SHAPES = {"q": (4096, 3072), "k": (1024, 3072), "v": (1024, 3072), "o": (3072, 4096), "gate": (8192, 3072),
          "up": (8192, 3072), "down": (3072, 8192)}
SGEMM_RATIO = 2.0  # K7's errors may be at most twice cuBLAS fp32's
TF32_MARGIN = 100.0  # and must lie this far below TF32's
# a decoder layer's output on the two routes, relative to its largest value:
# each projection within float32 rounding, carried through RoPE, the
# attention over 3,770 positions and the residual adds
LAYER_RTOL = 1e-5


@pytest.fixture
def card() -> torch.device:
    """The card with TF32 off, or a skip."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K7 runs on the card only")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _errors(y: torch.Tensor, x: torch.Tensor, w: torch.Tensor) -> tuple[float, float]:
    """The largest and the mean of ``|y - x w^T| / (|x| |w|^T)``, in float64."""
    x64, w64 = x.double(), w.double()
    rel = (y.double() - x64 @ w64.T).abs_().div_(x64.abs() @ w64.abs().T)
    return float(rel.max()), float(rel.mean())


def _operands(m: int, n: int, k: int, seed: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    g = torch.Generator(device=device).manual_seed(seed)
    return (torch.randn(m, k, generator=g, device=device),
            torch.randn(n, k, generator=g, device=device) * 0.02)


@pytest.mark.cuda
@pytest.mark.parametrize("m, name", [(M, name) for name in SHAPES] + [(m, "k") for m in (1, 63, 129, 3770)],
                         ids=[f"{name}-m{M}" for name in SHAPES] + [f"ragged-m{m}" for m in (1, 63, 129, 3770)])
def test_k7_error_against_float64(card, m, name):
    """K7 at a decoder shape: one product launch and two splits (x and the
    weight), its errors within twice cuBLAS fp32's and a hundredth of
    TF32's (where cuBLAS runs TF32: not on a single row)."""
    n, k = SHAPES[name]
    x, w = _operands(m, n, k, seed=m + n + k, device=card)
    with torch.inference_mode():
        reset_launch_counts()
        got = k7.split_linear(x, (w,), k7.WeightPlanes())[0]
        torch.cuda.synchronize()
        counts = launch_counts()
        err = _errors(got, x, w)
        del got
        sgemm = _errors(x @ w.T, x, w)
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            tf32 = _errors(x @ w.T, x, w)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
    assert counts["split_gemm"] == 1 and counts["split_gemm.planes"] == 2 and sum(counts.values()) == 3
    assert err[0] <= SGEMM_RATIO * sgemm[0] and err[1] <= SGEMM_RATIO * sgemm[1], (err, sgemm)
    if m > 1:  # cuBLAS takes a single row through its GEMV, which has no TF32 path
        assert TF32_MARGIN * err[0] <= tf32[0] and TF32_MARGIN * err[1] <= tf32[1], (err, tf32)


@pytest.mark.cuda
@pytest.mark.parametrize("rows, tile", [(129, k7.BLOCK_M), (7540, k7.BLOCK_M), (1280, k7.BLOCK_N), (300, k7.BLOCK_N)])
def test_split_kernel_is_plane_layout(card, rows, tile):
    """The split kernel writes ``plane_layout``'s bits, padding rows and
    all, including values whose parts reach bf16's subnormals."""
    x, _ = _operands(rows, 1, 3072, seed=rows, device=card)
    x[0, :64] = torch.tensor([1e-40, -3e-39, 2.0**-120, 1e38] * 16, device=card)
    with torch.inference_mode():
        assert torch.equal(k7._planes(x, tile), k7.plane_layout(x, tile))


@pytest.mark.cuda
def test_side_by_side_is_each_alone(card):
    """q|k|v in one launch gives each projection's bits alone."""
    x, _ = _operands(300, 1, 3072, seed=3, device=card)
    ws = tuple(_operands(1, n, 3072, seed=n, device=card)[1] for n in (4096, 1024, 1024))
    with torch.inference_mode():
        together = k7.split_linear(x, ws, k7.WeightPlanes())
        for y, w in zip(together, ws):
            assert torch.equal(y, k7.split_linear(x, (w,), k7.WeightPlanes())[0])


@pytest.mark.cuda
def test_decoder_layer_routes(card, monkeypatch):
    """One full-width decoder layer over the cell's 2 x 3,770 positions:
    four K7 launches, and the same output as on ``F.linear``'s route
    (``refusals`` made to refuse) within float32 rounding; no K7 launch
    under grad mode."""
    torch.manual_seed(0)
    layer = DecoderLayer(VOXTRAL_MINI_3B).to(card).eval()
    for lin in (layer.q, layer.k, layer.v, layer.o, layer.gate, layer.up, layer.down):
        torch.nn.init.normal_(lin.weight, 0.0, 0.02)  # the benchmark's draw
    h = torch.randn(2, 3770, VOXTRAL_MINI_3B.hidden, device=card)
    cos, sin = rope_tables(3770, VOXTRAL_MINI_3B.head_dim, VOXTRAL_MINI_3B.rope_theta, card, h.dtype)
    with torch.inference_mode():
        reset_launch_counts()
        got = layer(h, cos, sin)
        torch.cuda.synchronize()
        assert launch_counts()["split_gemm"] == 4 and launch_counts()["split_gemm.planes"] == 8
        with monkeypatch.context() as patch:
            patch.setattr(k7, "refusals", lambda x, w: ["forced"])
            reset_launch_counts()
            want = layer(h, cos, sin)
            torch.cuda.synchronize()
            assert launch_counts()["split_gemm"] == 0 and launch_counts()["split_gemm.planes"] == 0
    assert float((got - want).abs().max()) <= LAYER_RTOL * float(want.abs().max())
    reset_launch_counts()
    layer(h[:, :64], cos[:64], sin[:64]).sum().backward()  # grad mode: F.linear and its gradients
    assert sum(launch_counts().values()) == 0 and layer.q.weight.grad is not None
