"""K5 on the card: the CQCC kernel against the plain chain, and its route.

``frontend/cqcc.py::cqcc`` launches K5 on a float32 CUDA waveform of the
default configuration (``ops/cqcc.py::takes``); the plain chain
(``cqcc_from_cqt_mag(cqt(y))``, cuBLAS SGEMMs with TF32 off) computes the
same function on the card. The log quirk ``log(dB^2 + 1e-12)`` turns a dB
rounding near 0 dB into a large step, so frames whose regridded dB lies
within 1e-3 of 0 are left out, as the fused cell's reference leaves them.

Marked ``cuda``: without a card every test skips in its fixture. This file
imports no JAX, which the card machine lacks; ``tests/conftest.py`` does,
so on the card run it without the conftest:

    python3 -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cqcc_card.py
"""

import pytest
import torch

from audioanalysisdetector_tpu_torch.frontend.cqcc import CQCCConfig, _regrid_on, cqcc, cqcc_from_cqt_mag
from audioanalysisdetector_tpu_torch.frontend.cqt import cqt
from audioanalysisdetector_tpu_torch.frontend.db import amplitude_to_db
from audioanalysisdetector_tpu_torch.ops import cqcc as k5
from audioanalysisdetector_tpu_torch.ops import launch_counts, reset_launch_counts

CFG = CQCCConfig()
MIN_ABS_INTERP_DB = 1e-3  # portbench/configs/cqcc-fused.json, compare.min_abs_interp_db
# the coefficients (up to ~60), both fp32 on the card, on the frames compared:
# chip_smoke.py's K5_TOL, with its reason (an H100 read 1.24e-3 at most)
ATOL = 5e-3


@pytest.fixture
def card() -> torch.device:
    """The card with TF32 off, or a skip."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K5 runs on the card only")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _wave(shape, seed: int, device) -> torch.Tensor:
    return 0.1 * torch.randn(shape, generator=torch.Generator(device=device).manual_seed(seed), device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("rows, n", [(256, 32000), (5, 16000), (3, 512), (9, 32704)])
def test_k5_is_the_plain_chain(card, rows, n):
    y = _wave((rows, n), rows + n, card)
    with torch.inference_mode():
        reset_launch_counts()
        got = cqcc(y, CFG)
        torch.cuda.synchronize()
        assert launch_counts()["cqcc"] == 1
        mag = cqt(y, CFG.cqt)
        plain = cqcc_from_cqt_mag(mag, CFG)
        interp = _regrid_on(CFG.cqt, card, torch.float32) @ amplitude_to_db(mag, ref="max")
    keep = interp.abs().amin(dim=-2) >= MIN_ABS_INTERP_DB
    assert got.shape == plain.shape == (rows, 19, 1 + n // 512)
    assert torch.isfinite(got).all() and keep.float().mean() > 0.9
    assert float(((got - plain).abs() * keep[:, None, :]).max()) <= ATOL


@pytest.mark.cuda
def test_a_grad_input_and_an_odd_length_keep_the_plain_chain(card):
    reset_launch_counts()
    y = _wave((2, 32000), 1, card).requires_grad_(True)
    cqcc(y, CFG).sum().backward()
    assert y.grad is not None and torch.isfinite(y.grad).all()
    with torch.inference_mode():
        assert cqcc(_wave((2, 32001), 2, card), CFG).shape == (2, 19, 63)
    torch.cuda.synchronize()
    assert launch_counts()["cqcc"] == 0


@pytest.mark.cuda
def test_silence_is_exact_and_rows_are_independent(card):
    """A row gives the same CQCC alone and in a batch; an all-zero row's map
    is 0 dB everywhere, as in the plain chain, so its CQCC is the DCT of a
    constant log(1e-12): c0 = -253.2, where sums of 84 equal fp32 terms in
    other orders differ by a few ulps (both chains read 1.8e-4 from float64)."""
    y = _wave((4, 32000), 3, card)
    y[1] = 0
    with torch.inference_mode():
        both = cqcc(y, CFG)
        alone = k5.cqcc_kernel(y[2:3].clone(), CFG)
        plain_silence = cqcc_from_cqt_mag(cqt(y[1:2], CFG.cqt), CFG)
    assert torch.equal(both[2:3], alone)
    torch.testing.assert_close(both[1:2], plain_silence, rtol=0, atol=1e-3)
