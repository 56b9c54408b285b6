"""PyTorch port's ``ct_mel`` (K3) vs the JAX Pallas kernel, on the CPU.

On a CPU tensor the port's ``ct_mel`` is its plain version,
``ct_mel_reference`` (the same 64 x 32 factorization as plain matmuls); the
JAX kernel runs in Pallas interpret mode, as ``tests/test_ops_ct_mel.py``
runs it, and the JAX XLA mel path is the second reference. The cases mirror
that file's seven. The CUDA kernel itself is checked on the card by
``chip_smoke.py`` against the same plain version and K1's direct chain.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import audioanalysisdetector_tpu.frontend.mel as jmel
from audioanalysisdetector_tpu.frontend.db import power_to_db as j_power_to_db
from audioanalysisdetector_tpu.ops.ct_mel import _ct_operands as j_ct_operands
from audioanalysisdetector_tpu.ops.ct_mel import ct_log_mel as j_ct_log_mel
from audioanalysisdetector_tpu.ops.ct_mel import ct_mel as j_ct_mel
from audioanalysisdetector_tpu_torch.frontend import mel as tmel
from audioanalysisdetector_tpu_torch.frontend.stft import center_pad
from audioanalysisdetector_tpu_torch.ops import ct_mel as tct

torch.set_num_threads(2)

# log-mel in dB at ref="max", as tests/test_ops_ct_mel.py holds the kernel
# to the XLA path: fp32 sums of the same DFT in other orders
DB_TOL = 1e-4
# at a fixed ref=1.0 the absolute power is exposed (a doubled conjugate bin
# would show as ~3 dB): the bound of test_ct_log_mel_matches_under_numeric_ref
DB_TOL_NUMERIC_REF = 1e-3


def _wave(batch: int, n: int = 32000, seed: int = 0) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal((batch, n)) * 0.1).astype(np.float32)


def _both(y: np.ndarray, hop: int = 512, **kw):
    """(port ct_log_mel, JAX ct_log_mel interpret, JAX XLA log-mel) on ``y``."""
    tcfg, jcfg = tmel.MelConfig(hop_length=hop), jmel.MelConfig(hop_length=hop)
    ours = tct.ct_log_mel(torch.from_numpy(y), tcfg, **kw).numpy()
    pallas = np.asarray(j_ct_log_mel(jnp.asarray(y), jcfg, interpret=True, **kw))
    xla = np.asarray(jmel.log_mel_spectrogram(jnp.asarray(y), jcfg, **kw))
    return ours, pallas, xla


def test_ct_log_mel_matches_pallas_interpret_and_xla():
    ours, pallas, xla = _both(_wave(8))
    assert ours.shape == pallas.shape == (8, 64, 63)
    np.testing.assert_allclose(ours, pallas, rtol=0, atol=DB_TOL)
    np.testing.assert_allclose(ours, xla, rtol=0, atol=DB_TOL)


def test_ct_log_mel_matches_under_numeric_ref():
    ours, pallas, xla = _both(_wave(8, seed=1), ref=1.0)
    np.testing.assert_allclose(ours, pallas, rtol=0, atol=DB_TOL_NUMERIC_REF)
    np.testing.assert_allclose(ours, xla, rtol=0, atol=DB_TOL_NUMERIC_REF)


def test_ct_log_mel_silence_finite():
    ours, pallas, _ = _both(np.zeros((8, 32000), np.float32))
    assert np.isfinite(ours).all()
    np.testing.assert_array_equal(ours, pallas)  # both clip to the -100 dB floor


def test_ct_mel_rejects_bad_shapes():
    """The hop and n_fft constraints stay errors; the batch size does not
    (the TPU kernel raised on B % 8, the port takes any B)."""
    wp = torch.zeros(9, 34048)
    with pytest.raises(ValueError, match="hop"):
        tct.ct_mel(wp, tmel.MelConfig(hop_length=500), n_frames=63)
    with pytest.raises(ValueError, match="hop"):
        tct.ct_mel(wp, tmel.MelConfig(hop_length=384), n_frames=63)
    with pytest.raises(ValueError, match="n_fft"):
        tct.ct_mel(wp, tmel.MelConfig(n_fft=1024, hop_length=256), n_frames=63)
    with pytest.raises(ValueError, match="too short"):
        tct.ct_mel(wp, tmel.MelConfig(), n_frames=64)
    with pytest.raises(NotImplementedError, match="float32"):
        tct.ct_mel(wp.double(), tmel.MelConfig(), n_frames=63)
    with pytest.raises(NotImplementedError, match="no path"):
        tct.ct_mel(wp.to("meta"), tmel.MelConfig(), n_frames=63)
    before = tct.launches
    assert tct.ct_mel(wp, tmel.MelConfig(), n_frames=63).shape == (9, 63, 64)
    assert tct.launches == before  # the CPU path launches no kernel


def test_ct_log_mel_partial_batch_rows_equal_full():
    """B = 1 and 3 give the full batch's rows (the TPU wrapper pads them to
    its 8-utterance tile; the port needs no tile)."""
    y = _wave(8, seed=2)
    full = tct.ct_log_mel(torch.from_numpy(y), tmel.MelConfig()).numpy()
    for b in (1, 3):
        part = tct.ct_log_mel(torch.from_numpy(y[:b]), tmel.MelConfig()).numpy()
        assert part.shape == (b,) + full.shape[1:]
        np.testing.assert_allclose(part, full[:b], rtol=0, atol=1e-5)
        jpart = np.asarray(j_ct_log_mel(jnp.asarray(y[:b]), jmel.MelConfig(), interpret=True))
        np.testing.assert_allclose(part, jpart, rtol=0, atol=DB_TOL)


def test_ct_log_mel_zero_right_boundary_frames():
    """hop == n_fft with n % hop >= pad: every frame is interior in the JAX
    fast path (no right snippet); the port pads and frames as usual."""
    ours, pallas, xla = _both(_wave(8, n=9728, seed=3), hop=2048)
    assert ours.shape == pallas.shape == xla.shape == (8, 64, 5)
    np.testing.assert_allclose(ours, pallas, rtol=0, atol=DB_TOL)
    np.testing.assert_allclose(ours, xla, rtol=0, atol=DB_TOL)


def test_ct_log_mel_odd_length_and_padded_core():
    """Length 32032 (not a multiple of 64: the JAX fallback pad) against
    both references, and the core ``ct_mel`` on a padded signal against the
    JAX kernel's core."""
    ours, pallas, xla = _both(_wave(8, n=32032, seed=4))
    assert ours.shape == xla.shape == (8, 64, 63)
    np.testing.assert_allclose(ours, pallas, rtol=0, atol=DB_TOL)
    np.testing.assert_allclose(ours, xla, rtol=0, atol=DB_TOL)

    y = _wave(8, seed=5)
    wp = center_pad(torch.from_numpy(y), 2048).contiguous()
    ours = tct.ct_mel(wp, tmel.MelConfig(), n_frames=63).transpose(1, 2)
    ours = tct.power_to_db(ours, ref="max", utt_axes=2).numpy()
    ref = j_ct_mel(jnp.asarray(wp.numpy()), jmel.MelConfig(), n_frames=63, interpret=True)
    ref = np.asarray(j_power_to_db(jnp.swapaxes(ref, -1, -2), ref="max", utt_axes=2))
    np.testing.assert_allclose(ours, ref, rtol=0, atol=DB_TOL)


def test_ct_mel_frame_reach_rounds_up_to_64_as_the_tpu_kernel():
    """The TPU kernel zero-extends the padded signal to a multiple of 64 and
    checks the frames' reach against that: a signal 42 samples short of the
    last frame is taken (the missing samples read as zeros), 92 short is not."""
    y = _wave(8, n=33750, seed=7)
    tcfg, jcfg = tmel.MelConfig(), jmel.MelConfig()
    ours = tct.ct_mel(torch.from_numpy(y), tcfg, n_frames=63).numpy()  # reach 33792
    ref = np.asarray(j_ct_mel(jnp.asarray(y), jcfg, n_frames=63, interpret=True))
    peak = np.abs(ref).max(axis=(1, 2), keepdims=True)
    assert float((np.abs(ours - ref) / peak).max()) < 1e-5
    for fn in (lambda: tct.ct_mel(torch.from_numpy(y[:, :33700]), tcfg, n_frames=63),
               lambda: j_ct_mel(jnp.asarray(y[:, :33700]), jcfg, n_frames=63, interpret=True)):
        with pytest.raises(ValueError, match="too short"):
            fn()


def test_ct_operands_bitwise_pieces_of_the_jax_operands():
    tcfg = tmel.MelConfig()
    c32, s32, c64, s64, tr, ti, w_rs, melT = tct._ct_operands(tcfg)
    csA, wc, jtr, jti, jw, m6 = j_ct_operands(jmel.MelConfig())
    for a, b in ((c32, csA[:32, :32]), (s32, csA[:32, 32:]), (c64, wc[:64, :64]),
                 (s64, wc[:64, 64:]), (tr, jtr), (ti, jti), (w_rs, jw)):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    # m6[k2, k1] is the filterbank at bin k = k2 + 32 k1, halved on the
    # conjugate pairs 1..1023 and mirrored above 1024; the port keeps 0..1024
    half = melT.copy()
    half[1:1024] *= 0.5
    k = np.arange(32)[:, None] + 32 * np.arange(64)[None, :]
    m2048 = np.concatenate([half, half[1:1024][::-1]])
    np.testing.assert_array_equal(m2048[k], m6[:, :64])


def test_kernel_operands_spans_cover_every_weight():
    cfg = tmel.MelConfig()
    win, tw1, tw2, melw, spans = tct._kernel_operands(cfg, torch.device("cpu"))
    *_, w_rs, melT = tct._ct_operands(cfg)
    assert tuple(tw1.shape) == (32, 32, 2) and tuple(tw2.shape) == (1025, 2)
    np.testing.assert_array_equal(win.numpy(), w_rs.reshape(-1))
    lo, hi, row = spans.numpy()
    mask = np.zeros(melT.shape, bool)
    lane_of = {m: lane for rnd in tct.mel_lanes(cfg.n_mels) for part in rnd
               for lane, m in enumerate(part) if m >= 0}
    for m, (a, b) in enumerate(zip(lo.tolist(), hi.tolist())):
        mask[a:b, m] = True
        # the weights of bins a..b-1, in order, down the column of the lane that sums them
        np.testing.assert_array_equal(melw[row[m] : row[m] + b - a, lane_of[m]].numpy(), melT[a:b, m])
    assert not (melT[~mask]).any()  # nothing outside [lo, hi)
    assert int(np.count_nonzero(melw.numpy())) == int(np.count_nonzero(melT))


@pytest.mark.parametrize(
    "cfg, dtype, route",
    [
        (tmel.MelConfig(), torch.float32, "ct_mel"),  # the parity profile
        (tmel.MelConfig(hop_length=256), torch.float32, "ct_mel"),
        (tmel.MelConfig(hop_length=2048), torch.float32, "ct_mel"),
        (tmel.MelConfig.for_speech(), torch.float32, "wave_mel"),
        (tmel.MelConfig(hop_length=384), torch.float32, "wave_mel"),  # 2048 % 384
        (tmel.MelConfig(hop_length=160), torch.float32, "wave_mel"),  # hop % 64
        (tmel.MelConfig(n_fft=1024, hop_length=256), torch.float32, "wave_mel"),
        (tmel.MelConfig(power=1.0), torch.float32, "wave_mel"),
        (tmel.MelConfig(), torch.float64, "wave_mel"),
        (tmel.MelConfig(center=False), torch.float32, "wave_mel"),
        (tmel.MelConfig(pad_mode="constant"), torch.float32, "wave_mel"),
    ],
)
def test_mel_route_is_a_function_of_the_config(cfg, dtype, route):
    assert tmel.mel_route(cfg, dtype) == route


def test_cpu_melspectrogram_stays_the_plain_chain():
    y = torch.from_numpy(_wave(2, seed=6))
    before = tct.launches
    ours = tmel.melspectrogram(y, tmel.MelConfig()).numpy()
    ref = np.asarray(jmel.melspectrogram(jnp.asarray(y.numpy()), jmel.MelConfig()))
    assert tct.launches == before
    peak = np.abs(ref).max(axis=(1, 2), keepdims=True)
    assert float((np.abs(ours - ref) / peak).max()) < 1e-5
