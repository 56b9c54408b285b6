"""PyTorch port's ``fused_mel_from_frames`` (K2) vs the JAX Pallas kernel, on the CPU.

On a CPU tensor the port's ``fused_mel_from_frames`` is its plain version,
``fused_mel_from_frames_reference``; the JAX kernel runs in Pallas
interpret mode, as ``tests/test_ops_pallas.py`` runs it (the four K2 cases
there are mirrored here). The CUDA kernel (K1's core through its frames
entry point) is checked on the card by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import audioanalysisdetector_tpu.frontend.mel as jmel
from audioanalysisdetector_tpu.frontend.stft import frame_signal as j_frame_signal
from audioanalysisdetector_tpu.ops.fused_logmel import fused_log_mel_spectrogram as j_fused_log_mel
from audioanalysisdetector_tpu.ops.fused_logmel import fused_mel_from_frames as j_fused_mel
from audioanalysisdetector_tpu_torch.frontend import mel as tmel
from audioanalysisdetector_tpu_torch.ops import fused_logmel as tfl

torch.set_num_threads(2)

# mel power relative to each row's max: fp32 sums of n_fft products in
# another order (and over 64- vs 128-bin zero-padded tiles); in bf16 the
# inputs are rounded identically on both sides, so the same bound holds
REL_TOL = 1e-5
# log-mel in dB, as tests/test_ops_pallas.py::test_fused_logmel_end_to_end
DB_TOL = 1e-3
# bf16 against f32: median relative error (tests/test_ops_pallas.py:54)
BF16_MEDIAN_TOL = 0.02


def _frames(n: int, n_fft: int = 2048, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((n, n_fft)).astype(np.float32)


def _rel(got, ref):
    peak = np.maximum(np.abs(ref).max(axis=-1, keepdims=True), 1e-30)
    return float((np.abs(got - ref) / peak).max())


@pytest.mark.parametrize("profile", ["parity", "speech"])
def test_fused_mel_matches_reference_path(profile):
    tcfg, jcfg = tmel.MelConfig.for_profile(profile), jmel.MelConfig.for_profile(profile)
    y = (np.random.default_rng(1).standard_normal((2, 32000)) * 0.1).astype(np.float32)
    T = 1 + 32000 // tcfg.hop_length
    ref = np.asarray(jmel.melspectrogram(jnp.asarray(y), jcfg))  # (2, 64, T)
    flat = np.array(j_frame_signal(jnp.asarray(y), n_fft=jcfg.n_fft, hop_length=jcfg.hop_length))
    flat = flat.reshape(-1, jcfg.n_fft)
    before = tfl.launches
    ours = tfl.fused_mel_from_frames(torch.from_numpy(flat), tcfg).numpy()
    assert tfl.launches == before  # the CPU path launches no kernel
    pallas = np.asarray(j_fused_mel(jnp.asarray(flat), jcfg, interpret=True))
    assert ours.shape == pallas.shape == (2 * T, 64)
    assert _rel(ours, pallas) < REL_TOL
    np.testing.assert_allclose(ours.reshape(2, T, 64).transpose(0, 2, 1), ref, rtol=1e-4, atol=1e-5)


def test_fused_logmel_end_to_end():
    tcfg, jcfg = tmel.MelConfig(), jmel.MelConfig()
    y = (np.random.default_rng(2).standard_normal((3, 32000)) * 0.1).astype(np.float32)
    ours = tfl.fused_log_mel_spectrogram(torch.from_numpy(y), tcfg).numpy()
    ref = np.asarray(jmel.log_mel_spectrogram(jnp.asarray(y), jcfg))
    pallas = np.asarray(j_fused_log_mel(jnp.asarray(y), jcfg, interpret=True))
    assert ours.shape == ref.shape == (3, 64, 63)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=DB_TOL)
    np.testing.assert_allclose(ours, pallas, rtol=0, atol=DB_TOL)


def test_fused_mel_ragged_tile():
    """N not a multiple of any tile: the kernel masks its ragged row tile."""
    tcfg, jcfg = tmel.MelConfig(), jmel.MelConfig()
    frames = _frames(100, seed=3)
    ours = tfl.fused_mel_from_frames(torch.from_numpy(frames), tcfg).numpy()
    assert ours.shape == (100, 64)
    single = tfl.fused_mel_from_frames(torch.from_numpy(frames[:1]), tcfg).numpy()
    np.testing.assert_allclose(ours[:1], single, rtol=1e-5)
    pallas = np.asarray(j_fused_mel(jnp.asarray(frames), jcfg, interpret=True))
    assert _rel(ours, pallas) < REL_TOL


def test_fused_mel_bf16_close():
    tcfg, jcfg = tmel.MelConfig(), jmel.MelConfig()
    frames = _frames(128, seed=4)
    f32 = tfl.fused_mel_from_frames(torch.from_numpy(frames), tcfg).numpy()
    bf16 = tfl.fused_mel_from_frames(torch.from_numpy(frames), tcfg, compute_dtype="bfloat16").numpy()
    # the same bf16 rounding of frames and bases as the JAX kernel
    pallas = np.asarray(j_fused_mel(jnp.asarray(frames), jcfg, compute_dtype="bfloat16", interpret=True))
    assert _rel(bf16, pallas) < REL_TOL
    rel = np.abs(bf16 - f32) / np.maximum(np.abs(f32), 1e-3)
    assert np.median(rel) < BF16_MEDIAN_TOL
    assert np.median(rel) > 0  # the rounding did happen


def test_fused_mel_refuses_what_the_kernel_does_not_take():
    cfg = tmel.MelConfig()
    with pytest.raises(ValueError, match="compute_dtype"):
        tfl.fused_mel_from_frames(torch.zeros(4, 2048), cfg, compute_dtype="float16")
    with pytest.raises(ValueError, match="frames"):
        tfl.fused_mel_from_frames(torch.zeros(4, 512), cfg)
    with pytest.raises(NotImplementedError, match="float"):
        tfl.fused_mel_from_frames(torch.zeros(4, 2048, dtype=torch.int32), cfg)
    with pytest.raises(NotImplementedError, match="no path"):
        tfl.fused_mel_from_frames(torch.zeros(4, 2048, device="meta"), cfg)
