"""Floating-point operations and bytes, from a configuration's shapes alone.

One operation is one add or one multiply. Each count is what the
configuration's mathematics needs, however the port lays it out: the mel
projection counts the filterbank's nonzeros, the CQT each bin's own filter
length at its octave's rate, the second BiLSTM of the fused system its
forward pass and the one backward step that the last-step readout reads.
Elementwise work (dB, activations, normalisation) is left out: it is a few
operations per value against hundreds per frame.
"""

from __future__ import annotations

import math

import numpy as np

from portbench.reference.common import mel_filterbank


def frames(n_samples: int, hop: int) -> int:
    """Frames of a centred STFT or CQT of ``n_samples``: ``1 + n // hop``."""
    return 1 + n_samples // hop


def mel_nnz(cfg: dict) -> int:
    return int(np.count_nonzero(mel_filterbank(cfg["sr"], cfg["n_fft"], cfg["n_mels"])))


def mel_frame_ops(cfg: dict) -> float:
    """Per frame: a real FFT (2.5 N log2 N), the window (N), |X|^2 over the
    N/2 + 1 bins (3 each) and the mel weights (2 per nonzero)."""
    n = cfg["n_fft"]
    return 2.5 * n * math.log2(n) + n + 3 * (n // 2 + 1) + 2 * mel_nnz(cfg)


def mel_bound(cfg: dict, utterances: int) -> dict:
    """The least time the card could take for the mel power of
    ``utterances`` rows: the larger of the operations at the float32 peak
    and the bytes (each waveform sample read once, each mel value written
    once) at the memory peak."""
    from portbench.yardstick.peaks import FP32_FLOP_PER_S, HBM_BYTES_PER_S

    t = frames(cfg["n_samples"], cfg["hop_length"])
    ops = utterances * t * mel_frame_ops(cfg)
    nbytes = utterances * (cfg["n_samples"] * 4 + t * cfg["n_mels"] * 4)
    ops_s, bytes_s = ops / FP32_FLOP_PER_S, nbytes / HBM_BYTES_PER_S
    return {"bound_s": max(ops_s, bytes_s), "by": "operations" if ops_s >= bytes_s else "bytes",
            "ops": ops, "bytes": nbytes}


def lstm_step(i: int, h: int) -> float:
    """One step of one LSTM direction: the four gates' products with the
    input and the state."""
    return 2.0 * 4 * h * (i + h)


def cnn_bilstm_ops(cfg: dict) -> float:
    """``CNNBiLSTMHybrid`` on one utterance's log-mel: the Conv1d over the
    mel axis with the frames as channels, the BiLSTM over the pooled mel
    axis, the attention score, the two dense layers."""
    t = frames(cfg["n_samples"], cfg["hop_length"])
    c, k, m = cfg["conv_channels"], cfg["conv_kernel"], cfg["n_mels"]
    h, d = cfg["lstm_units"], cfg["dense_units"]
    steps = m // cfg["pool"]
    conv = 2.0 * t * k * c * m
    lstm = 2 * steps * lstm_step(c, h)
    heads = steps * 2.0 * 2 * h + 2.0 * 2 * h * d + 2.0 * d
    return conv + lstm + heads


def mel_score_ops(cfg: dict) -> float:
    """One utterance through the mel scorer: log-mel, then the model."""
    return frames(cfg["n_samples"], cfg["hop_length"]) * mel_frame_ops(cfg) + cnn_bilstm_ops(cfg)


def cqt_filter_lengths(cfg: dict) -> list[np.ndarray]:
    """Per octave (from the top), each bin's filter length at the octave's
    rate: ``ceil(Q sr_j / f)``, ``Q = filter_scale / (2^(1/B) - 1)``."""
    b, n_bins = cfg["bins_per_octave"], cfg["n_bins"]
    q = cfg["filter_scale"] / (2.0 ** (1.0 / b) - 1.0)
    freqs = cfg["fmin"] * 2.0 ** (np.arange(n_bins) / b)
    out = []
    for j in range(math.ceil(n_bins / b)):
        hi = n_bins - j * b
        f = freqs[max(hi - b, 0):hi]
        out.append(np.ceil(q * cfg["sr"] / 2**j / f))
    return out


def cqcc_ops(cfg: dict) -> float:
    """CQCC of one utterance: each bin's complex filter against the real
    signal (4 per tap) and its magnitude (3) in every frame; each octave's
    half-band decimation (2 per tap per output sample); the linear regrid
    (two weights a bin) and the DCT's retained rows."""
    t = frames(cfg["n_samples"], cfg["hop_length"])
    lengths = cqt_filter_lengths(cfg)
    cqt = sum(t * (4.0 * float(ls.sum()) + 3.0 * len(ls)) for ls in lengths)
    decim = sum(2.0 * cfg["decimation_taps"] * (cfg["n_samples"] >> (j + 1)) for j in range(len(lengths) - 1))
    n_bins = cfg["n_bins"]
    return cqt + decim + t * (2.0 * 2 * n_bins + 2.0 * cfg["n_ceps"] * n_bins)


def bilstm_classifier_ops(cfg: dict) -> float:
    """``BiLSTMClassifier``: both directions of the first BiLSTM over every
    frame; the second's forward pass and the single backward step at the
    last frame, which is all the last-step readout reads; the head."""
    t = frames(cfg["n_samples"], cfg["hop_length"])
    h, d = cfg["lstm_hidden"], cfg["n_ceps"]
    return 2 * t * lstm_step(d, h) + (t + 1) * lstm_step(2 * h, h) + 2.0 * 2 * h * cfg["classes"]


def gmm_pair_ops(cfg: dict) -> float:
    """Both diagonal GMMs' component log-densities in every frame:
    difference, square and weighted sum per dimension."""
    t = frames(cfg["n_samples"], cfg["hop_length"])
    return 2 * t * cfg["gmm_components"] * 3.0 * cfg["n_ceps"]


def fused_score_ops(cfg: dict) -> float:
    """One utterance through the fused scorer: CQCC, BiLSTM, both GMMs."""
    return cqcc_ops(cfg) + bilstm_classifier_ops(cfg) + gmm_pair_ops(cfg)

