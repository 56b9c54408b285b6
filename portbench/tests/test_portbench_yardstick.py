"""The yardstick's counts against hand arithmetic, for both configurations."""

from __future__ import annotations

import math

import numpy as np
import pytest

from portbench.harness.cells import BENCH_DIR, read_json
from portbench.yardstick import counts
from portbench.yardstick.peaks import FP32_FLOP_PER_S, HBM_BYTES_PER_S

MEL = read_json(BENCH_DIR / "configs" / "mel-parity.json")
CQCC = read_json(BENCH_DIR / "configs" / "cqcc-fused.json")


def slaney_nnz_by_hand(sr: int, n_fft: int, n_mels: int) -> int:
    """Nonzeros of the Slaney filterbank, bin by bin: a bin lies inside
    triangle m when its frequency is strictly between the triangle's feet."""
    def hz_to_mel(f):
        return f / (200.0 / 3) if f < 1000 else 15.0 + math.log(f / 1000.0) / (math.log(6.4) / 27.0)

    def mel_to_hz(m):
        return m * 200.0 / 3 if m < 15.0 else 1000.0 * math.exp((m - 15.0) * math.log(6.4) / 27.0)

    top = hz_to_mel(sr / 2)
    feet = [mel_to_hz(top * i / (n_mels + 1)) for i in range(n_mels + 2)]
    bins = [sr / 2 * k / (n_fft // 2) for k in range(n_fft // 2 + 1)]
    return sum(1 for m in range(n_mels) for f in bins if feet[m] < f < feet[m + 2])


def test_mel_filterbank_nonzeros():
    assert counts.mel_nnz(MEL) == slaney_nnz_by_hand(16000, 2048, 64)


def test_mel_score_ops_by_hand():
    nnz = slaney_nnz_by_hand(16000, 2048, 64)
    frame = 2.5 * 2048 * 11 + 2048 + 3 * 1025 + 2 * nnz
    conv = 2 * 63 * 3 * 64 * 64  # 1,548,288
    lstm = 2 * 32 * (2 * 4 * 32 * (64 + 32))  # 1,572,864
    heads = 32 * 2 * 64 + 2 * 64 * 64 + 2 * 64  # 12,416
    assert counts.frames(32000, 512) == 63
    assert counts.cnn_bilstm_ops(MEL) == conv + lstm + heads == 3_133_568
    assert counts.mel_score_ops(MEL) == pytest.approx(63 * frame + 3_133_568, rel=1e-12)
    assert 7.0e6 < counts.mel_score_ops(MEL) < 7.4e6


def test_mel_bound_by_hand():
    b = counts.mel_bound(MEL, 8192)
    nnz = slaney_nnz_by_hand(16000, 2048, 64)
    ops = 8192 * 63 * (2.5 * 2048 * 11 + 2048 + 3 * 1025 + 2 * nnz)
    nbytes = 8192 * (32000 * 4 + 63 * 64 * 4)
    assert b["ops"] == pytest.approx(ops, rel=1e-12)
    assert b["bytes"] == nbytes
    assert b["by"] == "operations"
    assert b["bound_s"] == pytest.approx(ops / FP32_FLOP_PER_S, rel=1e-12)
    assert b["bound_s"] > nbytes / HBM_BYTES_PER_S


def test_cqt_filter_lengths_by_hand():
    q = 1.0 / (2 ** (1 / 12) - 1)
    lengths = counts.cqt_filter_lengths(CQCC)
    assert len(lengths) == 7 and all(len(ls) == 12 for ls in lengths)
    top_bin = 32.70319566257483 * 2 ** (83 / 12)
    assert lengths[0][-1] == math.ceil(q * 16000 / top_bin)
    bottom_bin = 32.70319566257483
    assert lengths[6][0] == math.ceil(q * 16000 / 64 / bottom_bin)


def test_fused_score_ops_by_hand():
    t = 63
    taps = sum(float(ls.sum()) for ls in counts.cqt_filter_lengths(CQCC))
    cqt = t * (4 * taps + 3 * 84)
    decim = 2 * 63 * (16000 + 8000 + 4000 + 2000 + 1000 + 500)  # 3,969,000
    regrid_dct = t * (4 * 84 + 2 * 19 * 84)
    lstm1 = 2 * t * (2 * 4 * 128 * (19 + 128))  # 18,966,528
    lstm2 = (t + 1) * (2 * 4 * 128 * (256 + 128))  # 25,165,824
    head = 2 * 256 * 2
    gmm = 2 * t * 128 * 3 * 19  # 919,296
    assert counts.cqcc_ops(CQCC) == pytest.approx(cqt + decim + regrid_dct, rel=1e-12)
    assert counts.bilstm_classifier_ops(CQCC) == lstm1 + lstm2 + head == 44_133_376
    assert counts.gmm_pair_ops(CQCC) == gmm
    assert counts.fused_score_ops(CQCC) == pytest.approx(cqt + decim + regrid_dct + lstm1 + lstm2 + head + gmm,
                                                         rel=1e-12)


def test_counts_read_no_port_layout():
    src = (BENCH_DIR / "yardstick" / "counts.py").read_text()
    assert "audioanalysisdetector_tpu_torch" not in src and "_octave_kernel_bank" not in src


def test_published_peaks():
    assert FP32_FLOP_PER_S == 67e12 and HBM_BYTES_PER_S == 3.35e12
    assert np.isfinite(counts.fused_score_ops(CQCC))
