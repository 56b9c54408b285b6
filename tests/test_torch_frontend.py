"""PyTorch port's mel frontend vs the JAX package, on the CPU.

Same numpy inputs through both: framing, power spectrogram (matmul and fft),
mel power and log-mel, in both mel profiles, on random input, silence and a
fixed ``ref=1.0``. The JAX side runs as the JAX tests run it (CPU, matmul
precision "highest" from conftest.py).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import audioanalysisdetector_tpu.frontend.mel as jmel
from audioanalysisdetector_tpu.frontend.db import amplitude_to_db as j_amplitude_to_db
from audioanalysisdetector_tpu.frontend.db import power_to_db as j_power_to_db
from audioanalysisdetector_tpu.frontend.stft import frame_signal as j_frame_signal
from audioanalysisdetector_tpu.frontend.stft import power_spectrogram as j_power_spectrogram
from audioanalysisdetector_tpu_torch.frontend import db as tdb
from audioanalysisdetector_tpu_torch.frontend import mel as tmel

# the package's ``stft`` is the function (as in the JAX package): bind the module
tstft = importlib.import_module("audioanalysisdetector_tpu_torch.frontend.stft")

torch.set_num_threads(2)

PROFILES = ("parity", "speech")
# Power values relative to each utterance's max: both sides are fp32 sums of
# n_fft products in different orders (and FFT vs DFT for method="fft").
REL_TOL = 1e-5
# dB: a relative power error e moves the dB value by 4.3 e; values sit
# within top_db=80 dB of the max, where fp32 rounding of the small bins
# relative to the max still leaves < 1e-3 dB.
DB_TOL = 1e-3


def _wave(kind: str, batch: int = 2, n: int = 32000) -> np.ndarray:
    if kind == "silence":
        return np.zeros((batch, n), np.float32)
    rng = np.random.default_rng(7)
    t = np.arange(n) / 16000.0
    tone = 0.3 * np.sin(2 * np.pi * 440.0 * t)
    return (0.1 * rng.standard_normal((batch, n)) + tone).astype(np.float32)


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    peak = np.maximum(np.abs(ref).max(axis=(-2, -1), keepdims=True), 1e-30)
    return float((np.abs(got - ref) / peak).max())


@pytest.mark.parametrize("profile", PROFILES)
def test_frame_signal_matches_jax(profile):
    cfg = tmel.MelConfig.for_profile(profile)
    y = _wave("random")
    ours = tstft.frame_signal(torch.from_numpy(y), n_fft=cfg.n_fft, hop_length=cfg.hop_length)
    ref = j_frame_signal(jnp.asarray(y), n_fft=cfg.n_fft, hop_length=cfg.hop_length)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


@pytest.mark.parametrize("method", ["matmul", "fft"])
@pytest.mark.parametrize("profile", PROFILES)
@pytest.mark.parametrize("kind", ["random", "silence"])
def test_power_spectrogram_matches_jax(profile, method, kind):
    cfg = tmel.MelConfig.for_profile(profile)
    y = _wave(kind)
    kw = dict(n_fft=cfg.n_fft, hop_length=cfg.hop_length, method=method)
    ours = tstft.power_spectrogram(torch.from_numpy(y), **kw).numpy()
    ref = np.asarray(j_power_spectrogram(jnp.asarray(y), **kw))
    assert ours.shape == ref.shape == (2, cfg.n_fft // 2 + 1, 1 + 32000 // cfg.hop_length)
    assert _rel(ours, ref) < REL_TOL


@pytest.mark.parametrize("profile", PROFILES)
@pytest.mark.parametrize("kind", ["random", "silence"])
def test_melspectrogram_matches_jax(profile, kind):
    y = _wave(kind)
    ours = tmel.melspectrogram(torch.from_numpy(y), tmel.MelConfig.for_profile(profile)).numpy()
    ref = np.asarray(jmel.melspectrogram(jnp.asarray(y), jmel.MelConfig.for_profile(profile)))
    assert ours.shape == ref.shape
    assert _rel(ours, ref) < REL_TOL


@pytest.mark.parametrize("profile", PROFILES)
@pytest.mark.parametrize("kind,ref", [("random", "max"), ("silence", "max"), ("random", 1.0)])
def test_log_mel_matches_jax(profile, kind, ref):
    y = _wave(kind)
    ours = tmel.log_mel_spectrogram(torch.from_numpy(y), tmel.MelConfig.for_profile(profile), ref=ref)
    want = jmel.log_mel_spectrogram(jnp.asarray(y), jmel.MelConfig.for_profile(profile), ref=ref)
    np.testing.assert_allclose(ours.numpy(), np.asarray(want), rtol=0, atol=DB_TOL)


def test_log_mel_batched_leading_dims_and_fft_method():
    """(2, 2, n) batches keep per-utterance dB; method="fft" agrees too."""
    y = _wave("random", batch=4).reshape(2, 2, -1)
    cfg = tmel.MelConfig.for_speech()
    ours = tmel.log_mel_spectrogram(torch.from_numpy(y), cfg).numpy()
    flat = tmel.log_mel_spectrogram(torch.from_numpy(y.reshape(4, -1)), cfg).numpy()
    np.testing.assert_array_equal(ours.reshape(flat.shape), flat)
    fft = tmel.log_mel_spectrogram(
        torch.from_numpy(y), tmel.MelConfig(n_fft=512, hop_length=256, method="fft")
    ).numpy()
    np.testing.assert_allclose(fft, ours, rtol=0, atol=DB_TOL)


@pytest.mark.parametrize("ref", ["max", 1.0])
def test_amplitude_and_power_to_db_match_jax(ref):
    S = np.abs(np.random.default_rng(3).standard_normal((3, 5, 7))).astype(np.float32)
    S[1] = 0.0  # a silent utterance
    ours = tdb.power_to_db(torch.from_numpy(S), ref=ref, top_db=40.0).numpy()
    want = np.asarray(j_power_to_db(jnp.asarray(S), ref=ref, top_db=40.0))
    np.testing.assert_allclose(ours, want, rtol=0, atol=1e-4)
    ours = tdb.amplitude_to_db(torch.from_numpy(S), ref=ref).numpy()
    want = np.asarray(j_amplitude_to_db(jnp.asarray(S), ref=ref))
    np.testing.assert_allclose(ours, want, rtol=0, atol=1e-4)


def test_unknown_method_and_short_signal_raise():
    with pytest.raises(ValueError, match="unknown stft method"):
        tstft.power_spectrogram(torch.zeros(1, 4096), method="block")
    with pytest.raises(ValueError, match="shorter than one"):
        tstft.frame_signal(torch.zeros(1, 100), n_fft=512, hop_length=128, center=False)


@pytest.mark.parametrize("profile", ["parity", "speech"])
def test_the_plain_mel_takes_grad_after_an_inference_call(profile):
    """The mel chain's cached operators (``mel._filterbank_on``,
    ``stft._rdft_bases_on``) are normal tensors even when an
    ``inference_mode`` call built them, so a later grad-mode call in the
    same process still gets its backward."""
    tmel._filterbank_on.cache_clear()
    tstft._rdft_bases_on.cache_clear()
    cfg = tmel.MelConfig.for_profile(profile)
    wav = torch.from_numpy((np.random.default_rng(6).standard_normal((2, 4000)) * 0.1).astype(np.float32))
    with torch.inference_mode():
        first = tmel.melspectrogram(wav, cfg)
    x = wav.clone().requires_grad_()
    again = tmel.melspectrogram(x, cfg)
    again.sum().backward()
    assert torch.equal(first, again.detach())
    assert x.grad is not None and bool(torch.isfinite(x.grad).all()) and float(x.grad.abs().sum()) > 0
    assert not tmel._filterbank_on(cfg, x.device).is_inference()
    assert not any(b.is_inference() for b in tstft._rdft_bases_on(cfg.n_fft, cfg.window, cfg.win_length or cfg.n_fft, x.device))
