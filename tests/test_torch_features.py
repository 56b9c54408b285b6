"""The port's remaining frontends against the JAX package's, on the CPU.

MFCC (and its deltas + CMVN), LFCC with and without the int16 quirk, GFCC,
the wavelet-packet leaves and energies, the EDA spectrograms, the complex
and real/imaginary STFT, the iSTFT, and the formant analysis (intensity,
Burg LPC, tracks, the 10-key prosodic dict) run on the same numpy-seeded
inputs through both packages. The JAX side runs as its own tests run it
(CPU, matmul precision "highest" from conftest.py). On a CPU tensor the mel
chain is the plain one, so no kernel runs here: the card's K3 route of
``mfcc`` and ``melspectrogram_znorm`` is ``chip_smoke.py`` phase 12's.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import audioanalysisdetector_tpu.frontend as J
from audioanalysisdetector_tpu.frontend import formants as jform
from audioanalysisdetector_tpu.frontend.cepstral import CepstralConfig as JCepstralConfig
from audioanalysisdetector_tpu.frontend.mfcc import MFCCConfig as JMFCCConfig
from audioanalysisdetector_tpu.frontend.stft import _window_array as J_window_array
from audioanalysisdetector_tpu_torch.frontend import formants as tform
from audioanalysisdetector_tpu_torch.frontend.cepstral import CepstralConfig
from audioanalysisdetector_tpu_torch.frontend.mfcc import MFCCConfig

# the port's package namespace, where ``stft`` and ``istft`` are the functions
P = importlib.import_module("audioanalysisdetector_tpu_torch.frontend")

torch.set_num_threads(2)

SR = 16000
# cepstra (MFCC in dB units up to ~40, LFCC/GFCC log10 units up to ~40),
# absolute: fp32 DFT/mel/filterbank GEMMs summed in other orders, through
# log10 and the DCT (these inputs read <= 8.6e-6)
CEPS_TOL = 1e-4
# z-normed spectrograms, absolute on values of a few units: the mel one
# reads 2.9e-6; the CQT one 1.8e-4, its deep bins' dB carrying the fp32
# rounding of the CQT's banded GEMMs (tests/test_torch_cqcc.py) through ref=max
ZNORM_TOL = 1e-5
CQT_SPEC_TOL = 1e-3
# STFT values relative to the largest magnitude: fp32 sums of n_fft products
# (GEMM vs GEMM, pocketfft vs XLA's FFT for method="fft")
STFT_RTOL = 2e-6
# iSTFT waveform, absolute on signals of ~0.3, times 1 / the summed squared
# window at each sample: two GEMMs and the overlap-add in other orders
# (reads 3.3e-7), divided by that sum, which falls to ~1e-3 in the last
# samples of the centre padding (where a length past the signal reaches)
ISTFT_TOL = 1e-6
# intensity in dB (reads 7.6e-6 on values ~70), LPC coefficients (1.5e-8),
# formant frequencies relative to themselves (2.0e-5: the roots of an
# order-10 polynomial move by far more than its coefficients, ~1e-8 apart)
INTENSITY_TOL = 1e-4
LPC_TOL = 1e-6
FORMANT_RTOL = 1e-4


def _wave(rng, batch, n, scale=0.1):
    return (rng.standard_normal((batch, n)) * scale).astype(np.float32)


def _close(ours, ref, atol, rtol=0.0):
    ours = ours.numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    ref = np.asarray(ref)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    excess = np.abs(ours.astype(np.float64) - ref) - (atol + rtol * np.abs(ref))
    assert np.nan_to_num(excess, nan=0.0).max(initial=-1.0) <= 0, float(np.nanmax(excess))
    np.testing.assert_array_equal(np.isnan(ours), np.isnan(ref))


@pytest.mark.parametrize("n", [8000, 16001])
def test_mfcc_and_deltas_cmvn_match_jax(n, rng):
    y = _wave(rng, 2, n)
    y[1] += 0.3 * np.sin(2 * np.pi * 440.0 * np.arange(n) / SR).astype(np.float32)
    _close(P.mfcc(torch.from_numpy(y)), J.mfcc(jnp.asarray(y)), CEPS_TOL)
    _close(P.mfcc_deltas_cmvn(torch.from_numpy(y)), J.mfcc_deltas_cmvn(jnp.asarray(y)), CEPS_TOL)
    cfg, jcfg = MFCCConfig.for_sr(8000, n_mfcc=20), JMFCCConfig.for_sr(8000, n_mfcc=20)
    assert cfg == MFCCConfig(n_mfcc=20, mel=P.MelConfig(sr=8000, n_mels=128))
    _close(P.mfcc(torch.from_numpy(y), cfg), J.mfcc(jnp.asarray(y), jcfg), CEPS_TOL)


@pytest.mark.parametrize("quirk", [True, False])
def test_lfcc_matches_jax(quirk, rng):
    y = _wave(rng, 3, 6000)
    y[2] = 0.0  # silence: the log10 floor
    _close(P.lfcc(torch.from_numpy(y), apply_int16_quirk=quirk),
           J.lfcc(jnp.asarray(y), apply_int16_quirk=quirk), CEPS_TOL)
    _close(P.int16_quirk(torch.from_numpy(y * 2)), J.int16_quirk(jnp.asarray(y * 2)), 0.0)
    _close(P.pre_emphasis(torch.from_numpy(y), 0.9), J.pre_emphasis(jnp.asarray(y), 0.9), 0.0)


def test_gfcc_matches_jax(rng):
    y = _wave(rng, 2, 5321)  # a tail the framing zero-pads
    _close(P.gfcc(torch.from_numpy(y)), J.gfcc(jnp.asarray(y)), CEPS_TOL)
    cfg = CepstralConfig(fs=8000, nfilts=20, num_ceps=10, fb_kind="gammatone", low_freq=100.0)
    jcfg = JCepstralConfig(fs=8000, nfilts=20, num_ceps=10, fb_kind="gammatone", low_freq=100.0)
    assert cfg.n_frames(5321) == jcfg.n_frames(5321)
    _close(P.gfcc(torch.from_numpy(y), cfg), J.gfcc(jnp.asarray(y), jcfg), CEPS_TOL)


@pytest.mark.parametrize("level", [1, 2, 3])
def test_wavelet_packet_leaves_and_energies_match_jax(level, rng):
    y = _wave(rng, 2, 4001, scale=1.0)
    ours = P.wavelet_packet_leaves(torch.from_numpy(y), level=level)
    ref = J.wavelet_packet_leaves(jnp.asarray(y), level=level)
    assert len(ours) == len(ref) == 2**level
    for a, b in zip(ours, ref):
        _close(a, b, 1e-6)
    _close(P.wpt_energies(torch.from_numpy(y), level=level), J.wpt_energies(jnp.asarray(y), level=level),
           0.0, rtol=1e-5)
    # fewer samples than the 7-sample extension: numpy's symmetric pad repeats
    short = _wave(rng, 1, 5, scale=1.0)
    _close(P.wpt_energies(torch.from_numpy(short), level=level), J.wpt_energies(jnp.asarray(short), level=level),
           0.0, rtol=1e-5)


def test_eda_spectrograms_match_jax(rng):
    y = _wave(rng, 2, 16000)
    x = rng.standard_normal((3, 7, 11)).astype(np.float32) * 5 + 2
    _close(P.znorm(torch.from_numpy(x)), J.znorm(jnp.asarray(x)), 1e-6)
    _close(P.znorm(torch.from_numpy(x), utt_axes=1), J.znorm(jnp.asarray(x), utt_axes=1), 1e-6)
    _close(P.melspectrogram_znorm(torch.from_numpy(y)), J.melspectrogram_znorm(jnp.asarray(y)), ZNORM_TOL)
    spec = P.compute_cqt_spec(torch.from_numpy(y))
    assert spec.shape == (2, 108, 32)
    _close(spec, J.compute_cqt_spec(jnp.asarray(y)), CQT_SPEC_TOL)


@pytest.mark.parametrize("n_fft,hop", [(2048, 512), (400, 160)])
def test_stft_and_istft_match_jax(n_fft, hop, rng):
    y = _wave(rng, 2, 9000, scale=0.3)
    for method in ("fft", "matmul"):
        ref = np.asarray(J.stft(jnp.asarray(y), n_fft=n_fft, hop_length=hop, method=method))
        ours = P.stft(torch.from_numpy(y), n_fft=n_fft, hop_length=hop, method=method).numpy()
        assert ours.dtype == np.complex64 and ours.shape == ref.shape
        np.testing.assert_allclose(ours, ref, rtol=0, atol=STFT_RTOL * np.abs(ref).max())
    from audioanalysisdetector_tpu.frontend.stft import stft_realimag as j_stft_realimag
    from audioanalysisdetector_tpu_torch.frontend.stft import stft_realimag

    jre, jim = j_stft_realimag(jnp.asarray(y), n_fft=n_fft, hop_length=hop)
    re, im = stft_realimag(torch.from_numpy(y), n_fft=n_fft, hop_length=hop)
    peak = float(np.abs(np.asarray(jre)).max())
    _close(re, jre, STFT_RTOL * peak)
    _close(im, jim, STFT_RTOL * peak)
    # the inverse from the same spectrum: the rest of the length zero-padded
    # (length past the signal) or cut (length None, or inside it)
    jre, jim = np.array(jre), np.array(jim)
    T = jre.shape[-1]
    w2 = np.zeros(n_fft + (T - 1) * hop)
    for t in range(T):
        w2[t * hop : t * hop + n_fft] += J_window_array("hann", n_fft, n_fft) ** 2
    for length in (None, 9000, 8000, 9500):
        ref = np.asarray(J.istft(jnp.asarray(jre), jnp.asarray(jim), n_fft=n_fft, hop_length=hop, length=length))
        ours = P.istft(torch.from_numpy(jre), torch.from_numpy(jim), n_fft=n_fft, hop_length=hop, length=length)
        scale = np.ones(ref.shape[-1])
        live = w2[n_fft // 2 :][: ref.shape[-1]]
        scale[: len(live)] = np.maximum(live, 1e-8)
        _close(ours, ref, ISTFT_TOL / scale)
    if n_fft % hop == 0:  # the round trip recovers the interior
        rec = P.istft(re, im, n_fft=n_fft, hop_length=hop, length=9000).numpy()
        np.testing.assert_allclose(rec[:, n_fft:-n_fft], y[:, n_fft:-n_fft], atol=1e-5)


def _ar2(rng, f0, n, r=0.98, sr=SR):
    """Second-order AR process with a resonance at f0 (the JAX package's test signal)."""
    a1, a2 = -2 * r * np.cos(2 * np.pi * f0 / sr), r * r
    e = rng.standard_normal(n + 200) * 0.01
    y = np.zeros_like(e)
    for t in range(2, len(e)):
        y[t] = e[t] - a1 * y[t - 1] - a2 * y[t - 2]
    return y[200:].astype(np.float32)


def test_intensity_and_burg_match_jax(rng):
    loud = rng.standard_normal(SR // 2).astype(np.float32) * 0.3
    y = np.concatenate([loud, np.zeros(SR // 2, np.float32)])
    _close(P.intensity_db(torch.from_numpy(y), SR), J.intensity_db(jnp.asarray(y), SR), INTENSITY_TOL)
    frames = np.stack([_ar2(rng, f, 400) for f in (500.0, 1200.0, 2500.0)] + [_wave(rng, 1, 400)[0]])
    for order in (2, 10):
        _close(P.burg_lpc(torch.from_numpy(frames), order), J.burg_lpc(jnp.asarray(frames), order), LPC_TOL)


def _resonant(rng, n=8000):
    """Two formants (700 and 1800 Hz) then silence: segments that start and end."""
    y = _ar2(rng, 700.0, n)
    a1, a2 = -2 * 0.96 * np.cos(2 * np.pi * 1800.0 / SR), 0.96**2
    out = np.zeros_like(y)
    for t in range(2, len(y)):
        out[t] = y[t] - a1 * out[t - 1] - a2 * out[t - 2]
    return np.concatenate([out, np.zeros(4000, np.float32), out[:3000]]).astype(np.float32)


def test_formant_tracks_match_jax(rng):
    y = _resonant(rng)
    for kw in ({}, {"order": 6, "pre_emphasis": 0.0}):
        t_ref, f_ref = jform.formant_tracks(y, SR, **kw)
        t_ours, f_ours = tform.formant_tracks(y, SR, device="cpu", **kw)
        np.testing.assert_array_equal(t_ours, t_ref)
        np.testing.assert_array_equal(np.isnan(f_ours), np.isnan(f_ref))
        np.testing.assert_allclose(f_ours, f_ref, rtol=FORMANT_RTOL, atol=0)
        assert np.isfinite(f_ours[:, :2]).mean() > 0.3  # resonances were found


def test_analyze_formants_and_silence_matches_jax(rng):
    y = _resonant(rng)
    ref = jform.analyze_formants_and_silence(y, SR)
    ours = tform.analyze_formants_and_silence(y, SR, device="cpu")
    assert list(ours) == list(ref)
    assert 0.0 < ref["silence_ratio"] < 1.0 and ref["f1_total_segments"] >= 2
    for k, v in ref.items():
        if isinstance(v, int):
            assert type(ours[k]) is int and ours[k] == v, k
        else:
            assert abs(ours[k] - v) <= 1e-6, (k, ours[k], v)


def test_short_audio_raises_like_jax():
    y = np.zeros(300, np.float32)  # under one 40 ms window and one 25 ms frame
    for fn, ref in ((lambda: P.intensity_db(torch.from_numpy(y), SR), lambda: J.intensity_db(jnp.asarray(y), SR)),
                    (lambda: tform.formant_tracks(y, SR, device="cpu"), lambda: jform.formant_tracks(y, SR)),
                    (lambda: tform.analyze_formants_and_silence(y, SR, device="cpu"),
                     lambda: jform.analyze_formants_and_silence(y, SR))):
        with pytest.raises(ValueError) as ours:
            fn()
        with pytest.raises(ValueError) as theirs:
            ref()
        assert str(ours.value) == str(theirs.value)
