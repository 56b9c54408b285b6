"""The port's CQT -> CQCC chain, DCT, deltas and CMVN vs the JAX package, on the CPU.

The host operators must be bit-equal between the packages (the port keeps
numpy copies of the operator-building functions). The tensors are compared stage by stage on
the same waveforms, because the CQCC quirk ``log(dB**2 + 1e-12)`` turns a
small dB difference near 0 dB into a large one: the CQT magnitude relative
to each utterance's max, the dB map, then CQCC.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audioanalysisdetector_tpu.frontend.cqcc import CQCCConfig as JCQCCConfig
from audioanalysisdetector_tpu.frontend.cqcc import _linear_regrid_matrix as j_regrid
from audioanalysisdetector_tpu.frontend.cqcc import cqcc as j_cqcc
from audioanalysisdetector_tpu.frontend.cqcc import cqcc_from_cqt_mag as j_cqcc_from_mag
from audioanalysisdetector_tpu.frontend.cqt import CQTConfig as JCQTConfig
from audioanalysisdetector_tpu.frontend.cqt import _decim_block_for as j_block_for
from audioanalysisdetector_tpu.frontend.cqt import _decim_gemm_matrix as j_decim_matrix
from audioanalysisdetector_tpu.frontend.cqt import _decimate2 as j_decimate2
from audioanalysisdetector_tpu.frontend.cqt import _halfband_fir as j_fir
from audioanalysisdetector_tpu.frontend.cqt import _octave_dense_operator as j_dense
from audioanalysisdetector_tpu.frontend.cqt import _octave_kernel_bank as j_bank
from audioanalysisdetector_tpu.frontend.cqt import cqt as j_cqt
from audioanalysisdetector_tpu.frontend.db import amplitude_to_db as j_amplitude_to_db
from audioanalysisdetector_tpu.frontend.dct import dct_ii as j_dct_ii
from audioanalysisdetector_tpu.frontend.dct import dct_ii_matrix as j_dct_matrix
from audioanalysisdetector_tpu.frontend.mfcc import _savgol_delta_matrix as j_savgol
from audioanalysisdetector_tpu.frontend.mfcc import add_deltas as j_add_deltas
from audioanalysisdetector_tpu.frontend.mfcc import cmvn as j_cmvn
from audioanalysisdetector_tpu.frontend.mfcc import delta as j_delta
from audioanalysisdetector_tpu_torch.frontend.cqcc import (
    CQCCConfig,
    _linear_regrid_matrix,
    cqcc,
    cqcc_from_cqt_mag,
    transpose_cqcc,
)
from audioanalysisdetector_tpu_torch.frontend.cqt import (
    CQTConfig,
    _decim_block_for,
    _decim_gemm_matrix,
    _decimate2,
    _halfband_fir,
    _octave_dense_operator,
    _octave_kernel_bank,
    cqt,
    default_n_bins,
)
from audioanalysisdetector_tpu_torch.frontend.db import amplitude_to_db
from audioanalysisdetector_tpu_torch.frontend.dct import dct_ii, dct_ii_matrix
from audioanalysisdetector_tpu_torch.frontend.mfcc import _savgol_delta_matrix, add_deltas, cmvn, delta
from audioanalysisdetector_tpu_torch.score.e2e import make_e2e_train_step_inputs

torch.set_num_threads(2)

# CQT magnitude, relative to each utterance's max: fp32 sums of the same
# products in other orders (it reads 4.6e-7)
CQT_TOL = 5e-6
# the dB map: a relative error e of a bin moves it by 8.7 e dB, and bins
# reach ~65 dB under the max (it reads 4.5e-4)
DB_TOL = 5e-3
# CQCC, absolute, on coefficients up to ~50: the fp32 rounding of
# log(dB^2 + 1e-12) and the DCT sum (it reads 2.3e-5, the same when both
# packages start from the same magnitudes)
CQCC_TOL = 2e-4
# DCT, deltas and CMVN: one fp32 product or normalisation in another order
SMALL_TOL = 1e-5

CONFIGS = {16000: (CQTConfig(), JCQTConfig()), 22050: (CQTConfig.for_sr(22050), JCQTConfig.for_sr(22050))}


def _wave(batch: int, n: int, seed: int) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal((batch, n)) * 0.1).astype(np.float32)


def _rel(got, ref):
    peak = np.maximum(np.abs(ref).max(axis=tuple(range(1, ref.ndim)), keepdims=True), 1e-30)
    return float((np.abs(got - ref) / peak).max())


@pytest.mark.parametrize("sr", sorted(CONFIGS))
def test_host_operators_are_bit_equal(sr):
    tcfg, jcfg = CONFIGS[sr]
    assert (tcfg.q, tcfg.n_octaves, tcfg.n_bins) == (jcfg.q, jcfg.n_octaves, jcfg.n_bins)
    np.testing.assert_array_equal(tcfg.lengths(), jcfg.lengths())
    assert default_n_bins(sr) == tcfg.n_bins
    for octave in range(tcfg.n_octaves):
        (a, ka), (b, kb) = _octave_kernel_bank(tcfg, octave), j_bank(jcfg, octave)
        assert ka == kb and a.dtype == b.dtype and a.tobytes() == b.tobytes()
    n = 2 * sr + (-2 * sr) % 2 ** (tcfg.n_octaves - 1)
    for octave in range(3, tcfg.n_octaves):
        n_oct = n // 2**octave
        a = _octave_dense_operator(tcfg, octave, n_oct, 1 + 2 * sr // tcfg.hop_length)
        b = j_dense(jcfg, octave, n_oct, 1 + 2 * sr // tcfg.hop_length)
        assert a.tobytes() == b.tobytes()
    a, b = _linear_regrid_matrix(tcfg.n_bins, tcfg.fmin, 12), j_regrid(jcfg.n_bins, jcfg.fmin, 12)
    assert a.tobytes() == b.tobytes()


def test_decimation_and_dct_operators_are_bit_equal():
    assert _halfband_fir().tobytes() == j_fir().tobytes()
    for block in (128, 250, 256, 500, 512):
        assert _decim_gemm_matrix(63, block).tobytes() == j_decim_matrix(63, block).tobytes()
    assert all(_decim_block_for(n) == j_block_for(n) for n in range(100, 3000, 7))
    for n, n_out in ((84, 19), (96, 19), (40, None)):
        assert dct_ii_matrix(n, n_out).tobytes() == j_dct_matrix(n, n_out).tobytes()
    for t, order in ((63, 1), (63, 2), (87, 1)):
        assert _savgol_delta_matrix(t, 9, order).tobytes() == j_savgol(t, 9, order).tobytes()


def test_octave_classes_of_the_default_config():
    """The default 16 kHz config has both layouts: octaves 0-2 frame the
    signal (ceil(K / hop) <= 2), octaves 3-6 take the dense operator."""
    cfg = CQTConfig()
    shifts = [-(-_octave_kernel_bank(cfg, o)[1] // (cfg.hop_length >> o)) for o in range(cfg.n_octaves)]
    assert [s <= 2 for s in shifts] == [True] * 3 + [False] * 4


@pytest.mark.parametrize("n", [1000, 1018, 32000, 4000])
def test_decimate2_matches_jax(n):
    """Whole-block GEMM (1000: block 500; 32000; 4000) and the zero-padded
    body + halo path (1018 = 2 x 509 has no even divisor in [128, 512])."""
    y = _wave(3, n, seed=n)
    assert (_decim_block_for(n) is None) == (n == 1018)
    ours = _decimate2(torch.from_numpy(y)).numpy()
    ref = np.asarray(j_decimate2(jnp.asarray(y)))
    assert ours.shape == ref.shape == (3, n // 2)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=SMALL_TOL)


@pytest.mark.parametrize("sr,n", [(16000, 32000), (16000, 31963), (22050, 44100)])
def test_cqt_then_db_then_cqcc_match_jax(sr, n):
    """Every octave class; 31963 and 44100 are not multiples of 2**(n_octaves-1)
    (zero-padded to the chain's divisor, frame count from the true length)."""
    tcfg, jcfg = CONFIGS[sr]
    y = _wave(3, n, seed=sr + n)
    mag = cqt(torch.from_numpy(y), tcfg)
    jmag = j_cqt(jnp.asarray(y), jcfg)
    assert tuple(mag.shape) == jmag.shape == (3, tcfg.n_bins, 1 + n // tcfg.hop_length)
    assert _rel(mag.numpy(), np.asarray(jmag)) < CQT_TOL
    db = amplitude_to_db(mag, ref="max").numpy()
    jdb = np.asarray(j_amplitude_to_db(jmag, ref="max"))
    np.testing.assert_allclose(db, jdb, rtol=0, atol=DB_TOL)
    tq, jq = CQCCConfig(cqt=tcfg), JCQCCConfig(cqt=jcfg)
    ours = cqcc_from_cqt_mag(mag, tq).numpy()
    np.testing.assert_allclose(ours, np.asarray(j_cqcc_from_mag(jmag, jq)), rtol=0, atol=CQCC_TOL)
    np.testing.assert_array_equal(ours, cqcc(torch.from_numpy(y), tq).numpy())


def test_cqcc_shape_contract_and_layouts():
    """2 s at 16 kHz -> (19, 63); transpose_cqcc is the time-major view; the
    trainer's featurizer is cqcc itself; one utterance unbatched equals its row."""
    y = _wave(2, 32000, seed=3)
    feats = make_e2e_train_step_inputs(torch.from_numpy(y), CQCCConfig())
    assert feats.shape == (2, 19, 63)
    ref = np.asarray(j_cqcc(jnp.asarray(y)))
    np.testing.assert_allclose(feats.numpy(), ref, rtol=0, atol=CQCC_TOL)
    assert transpose_cqcc(feats).shape == (2, 63, 19)
    np.testing.assert_array_equal(transpose_cqcc(feats).numpy(), feats.numpy().swapaxes(1, 2))
    one = cqcc(torch.from_numpy(y[1]), CQCCConfig()).numpy()
    np.testing.assert_allclose(one, feats[1].numpy(), rtol=0, atol=CQCC_TOL)


def test_dct_delta_cmvn_match_jax():
    x = np.random.default_rng(4).standard_normal((3, 40, 63)).astype(np.float32)
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    for axis, n_out in ((-2, 13), (-1, None)):
        np.testing.assert_allclose(
            dct_ii(tx, axis=axis, n_out=n_out).numpy(), np.asarray(j_dct_ii(jx, axis=axis, n_out=n_out)),
            rtol=0, atol=SMALL_TOL,
        )
    for order in (1, 2):
        np.testing.assert_allclose(
            delta(tx, order=order, axis=-1).numpy(), np.asarray(j_delta(jx, order=order, axis=-1)),
            rtol=0, atol=SMALL_TOL,
        )
    np.testing.assert_allclose(add_deltas(tx).numpy(), np.asarray(j_add_deltas(jx)), rtol=0, atol=SMALL_TOL)
    for variance in (True, False):
        np.testing.assert_allclose(
            cmvn(tx, axis=-1, variance=variance).numpy(),
            np.asarray(j_cmvn(jx, axis=-1, variance=variance)), rtol=0, atol=SMALL_TOL,
        )
    with pytest.raises(ValueError, match="shorter than SG width"):
        delta(tx[..., :5])
