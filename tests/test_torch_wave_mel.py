"""PyTorch port's ``wave_mel`` (K1) vs the JAX Pallas kernel, on the CPU.

On a CPU tensor the port's ``wave_mel`` is its plain version,
``wave_mel_reference``; the JAX kernel runs in Pallas interpret mode, as
``tests/test_ops_pallas.py`` runs it. The CUDA kernel itself is checked on
the card by ``chip_smoke.py`` (phase 3), against the same plain version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import audioanalysisdetector_tpu.frontend.mel as jmel
from audioanalysisdetector_tpu.ops.wave_mel import wave_log_mel as j_wave_log_mel
from audioanalysisdetector_tpu.ops.wave_mel import wave_mel as j_wave_mel
from audioanalysisdetector_tpu_torch.frontend import mel as tmel
from audioanalysisdetector_tpu_torch.frontend.stft import center_pad
from audioanalysisdetector_tpu_torch.ops import wave_mel as twm

torch.set_num_threads(2)

# mel power relative to each utterance's max: fp32 sums of n_fft products in
# another order (and over 64- vs 256-bin zero-padded tiles)
REL_TOL = 1e-5
# log-mel in dB, as tests/test_ops_pallas.py::test_wave_direct_mel_matches_xla_path
DB_TOL = 1e-4


def _wave(batch: int, seed: int = 0) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal((batch, 32000)) * 0.1).astype(np.float32)


def _padded(y: np.ndarray, cfg) -> np.ndarray:
    return np.pad(y, ((0, 0), (cfg.n_fft // 2, cfg.n_fft // 2)), mode="reflect")


def _rel(got, ref):
    peak = np.maximum(np.abs(ref).max(axis=(1, 2), keepdims=True), 1e-30)
    return float((np.abs(got - ref) / peak).max())


@pytest.mark.parametrize("profile", ["parity", "speech"])
def test_wave_mel_matches_pallas_interpret(profile):
    tcfg, jcfg = tmel.MelConfig.for_profile(profile), jmel.MelConfig.for_profile(profile)
    y = _wave(8)
    T = 1 + y.shape[1] // tcfg.hop_length
    wp = _padded(y, tcfg)
    before = twm.launches
    ours = twm.wave_mel(torch.from_numpy(wp), tcfg, n_frames=T).numpy()
    assert twm.launches == before  # the CPU path launches no kernel
    ref = np.asarray(j_wave_mel(jnp.asarray(wp), jcfg, n_frames=T, interpret=True))
    assert ours.shape == ref.shape == (8, T, 64)
    assert _rel(ours, ref) < REL_TOL


def test_wave_log_mel_matches_pallas_interpret():
    tcfg, jcfg = tmel.MelConfig(), jmel.MelConfig()
    y = _wave(8, seed=1)
    ours = twm.wave_log_mel(torch.from_numpy(y), tcfg).numpy()
    ref = np.asarray(j_wave_log_mel(jnp.asarray(y), jcfg, interpret=True))
    np.testing.assert_allclose(ours, ref, rtol=0, atol=DB_TOL)
    # and it is the frontend's log-mel (the same chain through another door)
    np.testing.assert_allclose(
        ours, tmel.log_mel_spectrogram(torch.from_numpy(y), tcfg).numpy(), rtol=0, atol=DB_TOL
    )


def test_ragged_batch_needs_no_tiling():
    """B=3 is refused by the TPU kernel (B % 8); the port takes it and gives
    the rows the JAX kernel gives when the batch is padded to 8."""
    tcfg, jcfg = tmel.MelConfig.for_speech(), jmel.MelConfig.for_speech()
    y = _wave(3, seed=2)
    T = 1 + y.shape[1] // tcfg.hop_length
    ours = twm.wave_mel(torch.from_numpy(_padded(y, tcfg)), tcfg, n_frames=T).numpy()
    y8 = np.concatenate([y, np.zeros((5, y.shape[1]), np.float32)])
    ref = np.asarray(j_wave_mel(jnp.asarray(_padded(y8, jcfg)), jcfg, n_frames=T, interpret=True))
    assert ours.shape == (3, T, 64)
    assert _rel(ours, ref[:3]) < REL_TOL
    with pytest.raises(ValueError, match="multiple of"):
        j_wave_mel(jnp.asarray(_padded(y, jcfg)), jcfg, n_frames=T, interpret=True)


def test_wave_mel_unpadded_is_the_padded_call():
    cfg = tmel.MelConfig.for_speech()
    y = torch.from_numpy(_wave(2, seed=3))
    T = 1 + y.shape[1] // cfg.hop_length
    a = twm.wave_mel_unpadded(y.reshape(1, 2, -1), cfg).reshape(2, T, -1)
    b = twm.wave_mel(center_pad(y, cfg.n_fft).contiguous(), cfg, n_frames=T)
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_wave_mel_refuses_what_the_kernel_does_not_take():
    cfg = tmel.MelConfig.for_speech()
    wp = torch.zeros(2, 32000 + cfg.n_fft)
    T = 1 + 32000 // cfg.hop_length
    with pytest.raises(ValueError, match="too short"):
        twm.wave_mel(wp, cfg, n_frames=T + 1)
    # any power, any n_mels and bf16 are taken (the JAX chain computes them)
    with pytest.raises(NotImplementedError, match="float32 or bfloat16"):
        twm.wave_mel(wp.double(), cfg, n_frames=T)
    with pytest.raises(ValueError, match="contiguous"):
        twm.wave_mel(wp.t().contiguous().t(), cfg, n_frames=T)
    with pytest.raises(NotImplementedError, match="no path"):
        twm.wave_mel(wp.to("meta"), cfg, n_frames=T)


# the bf16 plain version against the JAX chain in bf16: both read the same
# bf16 samples, but the plain version (the kernel's function) meets them with
# bf16-rounded bases (2^-9 relative per basis value) where JAX keeps f32
# bases; relative to each utterance's max mel power (it reads 1.5e-3 at
# n_fft 512, 0.9e-3 at 2048)
BF16_REL_TOL = 5e-3


@pytest.mark.parametrize(
    "case,overrides,dtype,tol",
    [
        ("power1", dict(power=1.0), torch.float32, REL_TOL),
        ("power1.5", dict(power=1.5), torch.float32, REL_TOL),
        ("mels256", dict(n_mels=256), torch.float32, REL_TOL),
        ("bf16", {}, torch.bfloat16, BF16_REL_TOL),
    ],
)
def test_widened_reference_matches_jax_melspectrogram(case, overrides, dtype, tol):
    """What K1 used to refuse: its plain version against JAX
    ``melspectrogram`` (the XLA chain) on the same samples."""
    tcfg = tmel.MelConfig(n_fft=512, hop_length=256, **overrides)
    jcfg = jmel.MelConfig(n_fft=512, hop_length=256, **overrides)
    y = _wave(3, seed=4)
    T = 1 + y.shape[1] // tcfg.hop_length
    yt = torch.from_numpy(y).to(dtype)
    ours = twm.wave_mel(center_pad(yt, tcfg.n_fft).contiguous(), tcfg, n_frames=T)
    assert ours.dtype == torch.float32
    jy = jnp.asarray(y, dtype=jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    ref = np.asarray(jmel.melspectrogram(jy, jcfg), np.float32).transpose(0, 2, 1)
    assert ours.shape == ref.shape == (3, T, tcfg.n_mels)
    assert _rel(ours.numpy(), ref) < tol
    # the frontend's CPU chain is the JAX function itself (f32 bases)
    mel = tmel.melspectrogram(yt, tcfg).numpy().transpose(0, 2, 1)
    assert _rel(mel, ref) < REL_TOL
