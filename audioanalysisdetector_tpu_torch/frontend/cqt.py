"""Constant-Q transform, one octave at a time (PyTorch).

Counterpart of the JAX package's ``frontend/cqt.py``, librosa's
``cqt(y, sr, n_bins, bins_per_octave, fmin=C1)`` contract
(reference/ASV_dl_func.py:458): bins are taken one octave at a time against
a signal decimated by 2 per octave (a 63-tap half-band FIR, stride 2), so
every octave's bank of complex kernels (hann-windowed exponentials,
L1-normalized, times sqrt of the bin's filter length at the original rate:
librosa's ``scale=True``) has a short fixed length. The signal is
zero-padded (librosa's ``pad_mode='constant'``), so frame ``m`` is centered
at sample ``m * hop``.

The host-built operators (``_octave_kernel_bank``, ``_halfband_fir``,
``_decim_gemm_matrix``, ``_decim_block_for``, ``_octave_dense_operator``)
are copies of the JAX package's, so both packages build bit-identical
operators. The JAX package has no Pallas kernel here (XLA computes it), so
the port runs plain PyTorch products (cuBLAS on the card), in two layouts
that give the same numbers as the JAX package's three:

- top octaves (``ceil(K / hop) <= 2``): the zero-padded signal framed by
  ``unfold`` and one GEMM against the bank;
- deep octaves: one signal @ banded dense operator GEMM (the kernel spans
  many hops there, so framing would multiply the signal in memory);
- each decimation: the JAX package's banded-Toeplitz GEMM over whole blocks
  of the signal (``_decimate2``).

The JAX package's strided-view framing is a TPU layout for XLA's lowering
and has no counterpart; its ``_FORCE_*`` test hooks neither.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from audioanalysisdetector_tpu_torch.frontend.windows import get_window

C1_HZ = 32.70319566257483  # librosa.note_to_hz('C1') — reference/ASV_dl_func.py:454
_NUMTAPS = 63  # half-band FIR length of the decimation stages


def cqt_frequencies(n_bins: int, fmin: float, bins_per_octave: int = 12) -> np.ndarray:
    """Center frequencies ``fmin * 2**(k / B)`` (librosa.cqt_frequencies)."""
    return fmin * 2.0 ** (np.arange(n_bins) / bins_per_octave)


def default_n_bins(sr: float, fmin: float = C1_HZ, bins_per_octave: int = 12) -> int:
    """The reference's bin-count rule: floor(log2((sr/2 - 100)/fmin)) * B
    (reference/ASV_dl_func.py:455-456)."""
    fmax = sr / 2.0 - 100.0
    return int(np.floor(np.log2(fmax / fmin)) * bins_per_octave)


@dataclass(frozen=True)
class CQTConfig:
    sr: int = 16000
    hop_length: int = 512
    fmin: float = C1_HZ
    n_bins: int = 84  # default_n_bins(16000) == 84
    bins_per_octave: int = 12
    filter_scale: float = 1.0

    @staticmethod
    def for_sr(sr: int, hop_length: int = 512) -> "CQTConfig":
        return CQTConfig(sr=sr, hop_length=hop_length, n_bins=default_n_bins(sr))

    @property
    def q(self) -> float:
        return self.filter_scale / (2.0 ** (1.0 / self.bins_per_octave) - 1.0)

    @property
    def n_octaves(self) -> int:
        return int(np.ceil(self.n_bins / self.bins_per_octave))

    def lengths(self) -> np.ndarray:
        """Filter length of every bin at the original sample rate."""
        return self.q * self.sr / cqt_frequencies(self.n_bins, self.fmin, self.bins_per_octave)


@lru_cache(maxsize=None)
def _octave_kernel_bank(cfg: CQTConfig, octave: int) -> tuple[np.ndarray, int]:
    """Complex kernel bank for one octave at its decimated rate.

    Returns ``(kernels, kernel_len)`` where kernels is ``(2 * n_oct_bins, 1, K)``
    float32 — real parts then imaginary parts.

    ``octave`` counts from the TOP: octave 0 holds the highest
    ``bins_per_octave`` bins and runs at the full rate; octave j runs at
    ``sr / 2**j``.
    """
    b = cfg.bins_per_octave
    # bins for this octave (the DEEPEST octave holds the remainder when
    # n_bins % B != 0: hi-lo clamps at the bottom of the bin range)
    hi = cfg.n_bins - octave * b
    lo = max(hi - b, 0)
    freqs = cqt_frequencies(cfg.n_bins, cfg.fmin, b)[lo:hi]
    sr_oct = cfg.sr / (2**octave)
    lens_oct = np.ceil(cfg.q * sr_oct / freqs).astype(int)
    lens_orig = cfg.q * cfg.sr / freqs
    K = int(2 ** np.ceil(np.log2(lens_oct.max())))  # pad bank to pow2 length
    re = np.zeros((len(freqs), K), dtype=np.float64)
    im = np.zeros((len(freqs), K), dtype=np.float64)
    for i, (f, n_k) in enumerate(zip(freqs, lens_oct)):
        t = np.arange(n_k) - (n_k - 1) / 2.0
        w = get_window("hann", n_k, periodic=False)  # symmetric over the support
        w = w / w.sum()  # L1 normalization of the (real) envelope
        phase = 2 * np.pi * f * t / sr_oct
        # scale=True contract: multiply by sqrt(N_k at original sr)
        amp = w * np.sqrt(lens_orig[i])
        start = (K - n_k) // 2
        re[i, start : start + n_k] = amp * np.cos(phase)
        im[i, start : start + n_k] = -amp * np.sin(phase)
    kernels = np.concatenate([re, im], axis=0)[:, None, :].astype(np.float32)
    return kernels, K


@lru_cache(maxsize=None)
def _halfband_fir(numtaps: int = 63, cutoff: float = 0.475) -> np.ndarray:
    """Anti-aliasing FIR for decimation by 2 (kaiser-windowed sinc, gain 1)."""
    from scipy.signal import firwin

    return firwin(numtaps, cutoff, window=("kaiser", 8.0)).astype(np.float32)


_DECIM_BLOCK = 256  # input samples per GEMM block (128 outputs), padded path


@lru_cache(maxsize=None)
def _decim_gemm_matrix(numtaps: int = 63, block: int = _DECIM_BLOCK) -> np.ndarray:
    """Banded-Toeplitz form of the stride-2 half-band FIR.

    ``(block + numtaps - 1, block // 2)``: column t holds the taps aligned
    at output sample t (input offset 2t, rows shifted so row 0 is input
    sample ``-half`` relative to the block start). Mostly zeros: a
    ~(block + 62) / 63-fold FLOP overspend over the FIR itself.
    """
    h = _halfband_fir(numtaps)
    H = np.zeros((block + numtaps - 1, block // 2), dtype=np.float32)
    for t in range(block // 2):
        H[2 * t : 2 * t + numtaps, t] = h
    return H


@lru_cache(maxsize=None)
def _decim_block_for(n: int) -> int | None:
    """Largest even divisor of ``n`` in [128, 512], or None: a divisor block
    lets the signal reshape into whole blocks with no global pad copy."""
    best = None
    for b in range(128, 513, 2):
        if n % b == 0:
            best = b
    return best


@lru_cache(maxsize=None)
def _on(array_fn, args: tuple, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """``array_fn(*args)`` (a cached host operator) uploaded once per device and
    dtype, as a normal tensor even inside ``inference_mode``, so a later call
    that autograd records can use it."""
    a = array_fn(*args)
    with torch.inference_mode(False):
        return torch.from_numpy(a[0] if isinstance(a, tuple) else a).to(device, dtype)


def _decimate2(y: torch.Tensor) -> torch.Tensor:
    """Anti-aliased downsample by 2 along the last axis: (..., n) -> (..., n//2).

    Odd-length centered FIR + stride 2 keeps output sample t aligned with
    input sample 2t, so octave frame centers stay aligned across rates.
    With a divisor block (``_decim_block_for``) each block gets its 31-sample
    halos from its neighbours and the stage is one frames @ H GEMM;
    otherwise the signal is zero-padded to whole blocks and the body and
    halo take one GEMM each.
    """
    half = _NUMTAPS // 2
    n, lead = y.shape[-1], y.shape[:-1]
    block = _decim_block_for(n)
    if block is not None:
        H = _on(_decim_gemm_matrix, (_NUMTAPS, block), y.device, y.dtype)
        nb = n // block
        body = y.reshape(*lead, nb, block)
        prev_tail = F.pad(body[..., :-1, block - half :], (0, 0, 1, 0))
        next_head = F.pad(body[..., 1:, :half], (0, 0, 0, 1))
        frames = torch.cat([prev_tail, body, next_head], dim=-1)
        return (frames @ H).reshape(*lead, nb * (block // 2))
    block = _DECIM_BLOCK
    n_blocks = -(-n // block)
    x = F.pad(y, (half, (n_blocks + 1) * block - n + half))
    body = x[..., : n_blocks * block].reshape(*lead, n_blocks, block)
    halo = x[..., block : (n_blocks + 1) * block].reshape(*lead, n_blocks, block)[..., : _NUMTAPS - 1]
    H = _on(_decim_gemm_matrix, (_NUMTAPS, block), y.device, y.dtype)
    out = body @ H[:block] + halo @ H[block:]
    return out.reshape(*lead, n_blocks * (block // 2))[..., : n // 2]


@lru_cache(maxsize=None)
def _octave_dense_operator(cfg: CQTConfig, octave: int, n_oct: int, n_frames: int) -> np.ndarray:
    """Whole-octave analysis as ONE dense operator ``(n_oct, T * 2nb)``.

    For deep octaves the kernel length K far exceeds the octave hop, so
    framing would inflate the tiny decimated signal ~K/hop-fold in memory; a
    banded dense operator applied as a single signal @ Op GEMM reads the
    signal once.
    """
    kernels, K = _octave_kernel_bank(cfg, octave)
    bank = kernels[:, 0, :]  # (2nb, K)
    hop = cfg.hop_length // (2**octave)
    nb2 = bank.shape[0]
    op = np.zeros((n_oct, n_frames * nb2), dtype=np.float32)
    for m in range(n_frames):
        start = m * hop - K // 2  # kernel centered at m*hop, zero-padded edges
        k_lo = max(-start, 0)
        k_hi = min(K, n_oct - start)
        if k_hi <= k_lo:
            continue
        op[start + k_lo : start + k_hi, m * nb2 : (m + 1) * nb2] = bank[:, k_lo:k_hi].T
    return op


def _bank(cfg: CQTConfig, octave: int) -> np.ndarray:
    """The octave's kernels as a ``(K, 2nb)`` GEMM operand."""
    return np.ascontiguousarray(_octave_kernel_bank(cfg, octave)[0][:, 0, :].T)


def cqt(y: torch.Tensor, cfg: CQTConfig = CQTConfig()) -> torch.Tensor:
    """Magnitude CQT of ``(..., n)`` waveforms -> ``(..., n_bins, n_frames)``.

    ``hop_length`` must be divisible by ``2**(n_octaves - 1)``. A length
    that is not is zero-padded to the decimation chain's divisor; the frame
    count keeps the original length's ``1 + n // hop``.
    """
    div = 2 ** (cfg.n_octaves - 1)
    if cfg.hop_length % div:
        raise ValueError(f"hop_length {cfg.hop_length} must be divisible by 2**(n_octaves-1)={div}")
    n_frames = 1 + y.shape[-1] // cfg.hop_length
    if y.shape[-1] % div:
        y = F.pad(y, (0, div - y.shape[-1] % div))
    lead = y.shape[:-1]
    cur = y
    octs: list[torch.Tensor] = []
    for octave in range(cfg.n_octaves):
        _, K = _octave_kernel_bank(cfg, octave)
        hop = cfg.hop_length // (2**octave)
        n_cur = cur.shape[-1]
        if -(-K // hop) <= 2:
            # top octaves: frame m is the zero-padded window [m*hop - K/2, m*hop + K/2)
            right = max((n_frames - 1) * hop + K - K // 2 - n_cur, 0)
            frames = F.pad(cur, (K // 2, right)).unfold(-1, K, hop)[..., :n_frames, :]
            resp = frames @ _on(_bank, (cfg, octave), y.device, y.dtype)
        else:
            op = _on(_octave_dense_operator, (cfg, octave, n_cur, n_frames), y.device, y.dtype)
            resp = (cur @ op).reshape(*lead, n_frames, -1)
        nb = resp.shape[-1] // 2
        re, im = resp[..., :nb], resp[..., nb:]
        octs.append(torch.sqrt(re * re + im * im).transpose(-1, -2))
        if octave + 1 < cfg.n_octaves:
            cur = _decimate2(cur)
    # octs[0] holds the TOP bins; stack lowest-first to match bin order
    return torch.cat(octs[::-1], dim=-2)
