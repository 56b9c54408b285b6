"""K3 on the card: the raw-input route against the padded route, bitwise.

``ct_mel_unpadded`` on a CUDA tensor launches K3 on the raw rows, which
reflects the edge frames' samples itself (librosa's center reflect pad
folded into its frame addressing); ``ct_mel`` of ``center_pad``'s rows is
the same kernel on rows padded beforehand. Everything after the load is
the same code, so the two are held bitwise equal.

Marked ``cuda``: without a card every test skips in its fixture. This file
imports no JAX, which the card machine lacks; ``tests/conftest.py`` does,
so on the card run it without the conftest:

    python3 -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_ct_mel_card.py
"""

import pytest
import torch

from audioanalysisdetector_tpu_torch.frontend.mel import MelConfig
from audioanalysisdetector_tpu_torch.frontend.stft import center_pad
from audioanalysisdetector_tpu_torch.ops import ct_mel as ctm
from audioanalysisdetector_tpu_torch.ops import launch_counts, reset_launch_counts


@pytest.fixture
def card() -> torch.device:
    """The card, or a skip with the reason."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K3 runs on the card only")
    return torch.device("cuda")


def _wave(shape: tuple[int, ...], seed: int, device: torch.device) -> torch.Tensor:
    g = torch.Generator(device=device).manual_seed(seed)
    return 0.1 * torch.randn(shape, generator=g, device=device)


def _padded_route(y: torch.Tensor, cfg: MelConfig) -> torch.Tensor:
    n = y.shape[-1]
    return ctm.ct_mel(center_pad(y, cfg.n_fft, cfg.pad_mode), cfg, n_frames=1 + n // cfg.hop_length)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "batch, n, n_mels, layout",
    [
        (4, 1025, 64, "contiguous"),  # every frame reflects, the last ones on both sides
        (4, 1500, 64, "contiguous"),
        (4, 2047, 64, "contiguous"),
        (4, 8000, 64, "contiguous"),
        (64, 32000, 64, "contiguous"),  # the cell's length: 4 edge frames in 63
        (64, 32001, 64, "contiguous"),  # odd rows: the 4-byte-load instance
        (3, 8192, 64, "contiguous"),  # 51 frame rows: the last block's last warps idle
        (16, 32000, 128, "contiguous"),  # the MFCC configuration
        (16, 32000, 64, "column_slice"),  # a non-contiguous input
    ],
)
def test_raw_route_is_bitwise_the_padded_route(card, batch, n, n_mels, layout):
    cfg = MelConfig(n_mels=n_mels)
    if layout == "column_slice":
        y = _wave((batch, n + 100), n, card)[:, 50 : 50 + n]
        assert not y.is_contiguous()
    else:
        y = _wave((batch, n), n, card)
    reset_launch_counts()
    raw = ctm.ct_mel_unpadded(y, cfg)
    padded = _padded_route(y, cfg)
    torch.cuda.synchronize()
    assert raw.shape == (batch, 1 + n // cfg.hop_length, n_mels)
    assert torch.isfinite(raw).all()
    assert torch.equal(raw, padded)
    assert launch_counts()["ct_mel"] == 2 and launch_counts()["ct_mel.reflect"] == 1


@pytest.mark.cuda
def test_lead_axes_are_kept(card):
    cfg = MelConfig()
    y = _wave((2, 3, 8000), 5, card)
    raw = ctm.ct_mel_unpadded(y, cfg)
    assert raw.shape == (2, 3, 16, 64)
    assert torch.equal(raw, _padded_route(y.reshape(6, 8000), cfg).reshape(2, 3, 16, 64))


@pytest.mark.cuda
def test_reflect_counter_counts_raw_launches_only(card):
    cfg = MelConfig()
    y = _wave((2, 32000), 3, card)
    reset_launch_counts()
    _padded_route(y, cfg)
    assert launch_counts()["ct_mel"] == 1 and launch_counts()["ct_mel.reflect"] == 0
    ctm.ct_mel_unpadded(y, cfg)
    assert launch_counts()["ct_mel"] == 2 and launch_counts()["ct_mel.reflect"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1024, 600])
def test_too_short_raises_what_center_pad_raises(card, n):
    y = _wave((2, n), 4, card)
    with pytest.raises(RuntimeError) as padded:
        center_pad(y, 2048)
    reset_launch_counts()
    with pytest.raises(type(padded.value), match="Padding size should be less"):
        ctm.ct_mel_unpadded(y, MelConfig())
    assert launch_counts()["ct_mel"] == 0 and launch_counts()["ct_mel.reflect"] == 0


@pytest.mark.cuda
def test_raw_route_refuses_grad(card):
    y = _wave((2, 32000), 6, card).requires_grad_()
    reset_launch_counts()
    with pytest.raises(RuntimeError, match="no backward"):
        ctm.ct_mel_unpadded(y, MelConfig())
    assert launch_counts()["ct_mel"] == 0
