"""K3 on the card: the raw-input route against the padded route, and the dB
instance against the power instance + ``power_to_db``, bitwise.

``ct_mel_unpadded`` on a CUDA tensor launches K3 on the raw rows, which
reflects the edge frames' samples itself (librosa's center reflect pad
folded into its frame addressing); ``ct_mel`` of ``center_pad``'s rows is
the same kernel on rows padded beforehand. Everything after the load is
the same code, so the two are held bitwise equal. ``ct_mel_db`` (the route
of ``log_mel_spectrogram``) runs the same frame code into a shared-memory
tile and ``power_to_db``'s steps in its epilogue, each rounded as torch's
kernels round it, so it is held bitwise to ``power_to_db`` of
``ct_mel_unpadded``'s power.

Marked ``cuda``: without a card every test skips in its fixture. This file
imports no JAX, which the card machine lacks; ``tests/conftest.py`` does,
so on the card run it without the conftest:

    python3 -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_ct_mel_card.py
"""

import pytest
import torch

from audioanalysisdetector_tpu_torch.frontend.db import power_to_db
from audioanalysisdetector_tpu_torch.frontend.mel import MelConfig, log_mel_spectrogram, melspectrogram
from audioanalysisdetector_tpu_torch.frontend.stft import center_pad
from audioanalysisdetector_tpu_torch.ops import ct_mel as ctm
from audioanalysisdetector_tpu_torch.ops import LAUNCH_COUNTERS, launch_counts, reset_launch_counts


@pytest.fixture
def card() -> torch.device:
    """The card, or a skip with the reason."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K3 runs on the card only")
    return torch.device("cuda")


def _wave(shape: tuple[int, ...], seed: int, device: torch.device) -> torch.Tensor:
    g = torch.Generator(device=device).manual_seed(seed)
    return 0.1 * torch.randn(shape, generator=g, device=device)


def _k3_launches(padded: int, raw: int) -> dict[str, int]:
    """The whole ledger after ``padded`` + ``raw`` K3 launches and no other."""
    return {**dict.fromkeys(LAUNCH_COUNTERS, 0), "ct_mel": padded + raw, "ct_mel.reflect": raw}


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
    assert launch_counts() == _k3_launches(padded=1, raw=1)


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
    assert launch_counts() == _k3_launches(padded=1, raw=0)
    ctm.ct_mel_unpadded(y, cfg)
    assert launch_counts() == _k3_launches(padded=1, raw=1)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1024, 600])
def test_too_short_raises_what_center_pad_raises(card, n):
    y = _wave((2, n), 4, card)
    with pytest.raises(RuntimeError) as padded:
        center_pad(y, 2048)
    reset_launch_counts()
    with pytest.raises(type(padded.value), match="Padding size should be less"):
        ctm.ct_mel_unpadded(y, MelConfig())
    assert set(launch_counts().values()) == {0}


@pytest.mark.cuda
def test_raw_route_refuses_grad(card):
    y = _wave((2, 32000), 6, card).requires_grad_()
    reset_launch_counts()
    with pytest.raises(RuntimeError, match="no backward"):
        ctm.ct_mel_unpadded(y, MelConfig())
    assert set(launch_counts().values()) == {0}


def _power_then_db(y: torch.Tensor, cfg: MelConfig, top_db) -> torch.Tensor:
    """The power instance and ``power_to_db``: the dB route's yardstick, as
    ``log_mel_spectrogram`` computed it before the dB instance."""
    return power_to_db(ctm.ct_mel_unpadded(y, cfg).transpose(-1, -2), ref="max", top_db=top_db)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "batch, n, n_mels, top_db",
    [
        (8192, 32000, 64, 80.0),  # the cell's call
        (64, 16000, 64, 80.0),  # T = 32
        (64, 64000, 64, 80.0),  # T = 126
        (1, 32000, 64, 80.0),
        (7, 32000, 64, 80.0),
        (8193, 32000, 64, 80.0),
        (16, 32000, 64, None),
        (16, 32000, 64, 0.0),
        (16, 32000, 64, 80.3),
        (16, 32001, 64, 80.0),  # odd rows: the 4-byte-load instance
        (16, 32000, 128, 80.0),  # 128 mels, T * n_mels = 8,064
        (4, 95743, 64, 80.0),  # T = 187, the largest tile at 64 mels
        (4, 1500, 64, 80.0),  # every frame reflects
    ],
)
def test_db_route_is_bitwise_power_then_power_to_db(card, batch, n, n_mels, top_db):
    cfg = MelConfig(n_mels=n_mels)
    y = _wave((batch, n), batch + n, card)
    assert ctm.db_refusals(y, cfg, top_db=top_db) == []
    reset_launch_counts()
    got = log_mel_spectrogram(y, cfg, top_db=top_db)
    assert launch_counts() == {**_k3_launches(padded=0, raw=1), "ct_mel.db": 1}
    want = _power_then_db(y, cfg, top_db)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (batch, n_mels, 1 + n // cfg.hop_length)
    assert got.stride() == want.stride()
    assert torch.isfinite(got).all()
    assert torch.equal(got, want)
    assert torch.equal(ctm.ct_log_mel(y, cfg, top_db=top_db), want)


@pytest.mark.cuda
@pytest.mark.parametrize("top_db", [80.0, None, 0.0])
def test_db_route_on_silence_and_planted_peaks(card, top_db):
    """An all-zero utterance (Smax < amin: every value 0 dB), one of a
    single loud sample, and ordinary ones beside them in one launch."""
    cfg = MelConfig()
    y = _wave((6, 32000), 11, card)
    y[0] = 0.0
    y[1] = 0.0
    y[1, 16000] = 1.0
    y[2] *= 1e-6
    got = log_mel_spectrogram(y, cfg, top_db=top_db)
    want = _power_then_db(y, cfg, top_db)
    assert torch.equal(got, want)
    assert torch.equal(got[0], torch.zeros_like(got[0]))


@pytest.mark.cuda
def test_db_route_strides_are_todays(card):
    """The model reads the features in the layout the power route gave them:
    ``melspectrogram``'s transpose, and ``power_to_db``'s output of it."""
    cfg = MelConfig()
    y = _wave((8, 32000), 12, card)
    got = log_mel_spectrogram(y, cfg)
    assert got.stride() == power_to_db(melspectrogram(y, cfg), ref="max").stride() == (63 * 64, 1, 64)


@pytest.mark.cuda
def test_a_scorer_call_is_one_db_launch(card):
    from audioanalysisdetector_tpu_torch.score.e2e import init_mel_cnn_bilstm, make_mel_cnn_bilstm_scorer

    cfg = MelConfig()
    score = make_mel_cnn_bilstm_scorer(init_mel_cnn_bilstm(cfg, 32000, device=card), cfg)
    y = _wave((32, 32000), 13, card)
    score(y)
    reset_launch_counts()
    score(y)
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts["ct_mel"] == counts["ct_mel.db"] == counts["ct_mel.reflect"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("n, n_mels", [(96000, 64), (32000, 256)])
def test_a_tile_that_does_not_fit_takes_the_power_route(card, n, n_mels):
    """T * n_mels past 12,016 (T = 188 at 64 mels; 256 mels at 2 s): the
    power instance and ``power_to_db``, no dB launch."""
    cfg = MelConfig(n_mels=n_mels)
    y = _wave((3, n), 14, card)
    assert ctm.db_refusals(y, cfg) == ["tile"]
    reset_launch_counts()
    got = log_mel_spectrogram(y, cfg)
    assert launch_counts() == _k3_launches(padded=0, raw=1)
    assert torch.equal(got, _power_then_db(y, cfg, 80.0))


@pytest.mark.cuda
def test_db_route_refuses_grad(card):
    y = _wave((2, 32000), 15, card).requires_grad_()
    assert ctm.db_refusals(y, MelConfig()) == ["grad"]
    reset_launch_counts()
    with pytest.raises(RuntimeError, match="no backward"):
        log_mel_spectrogram(y, MelConfig())
    assert set(launch_counts().values()) == {0}
    with torch.no_grad():
        got = log_mel_spectrogram(y, MelConfig())
    assert launch_counts()["ct_mel.db"] == 1
    assert torch.equal(got, _power_then_db(y.detach(), MelConfig(), 80.0))
