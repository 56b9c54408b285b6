"""Deterministic synthetic surrogate corpus with vocoder-style spoof artifacts.

No ASVspoof audio exists in this environment, so the quality north star
(EER vs the reference's 0.2565, BASELINE.md) needs an in-env proxy whose
difficulty is stable across rounds. This module generates speech-like
bonafide utterances (glottal source-filter synthesis: drifting F0 with
jitter/shimmer, formant resonators, syllabic gating, breath noise) and
spoofed versions carrying the artifact families TTS/VC systems exhibit,
in three difficulty tiers:

- ``A01`` (easy): phase-vocoder resynthesis — STFT magnitude kept, phase
  randomized, i.e. the classic buzzy griffin-lim artifact;
- ``A02`` (medium): spectral-envelope over-smoothing + F0 quantization
  (no micro-prosody), the statistical-parametric signature;
- ``A03`` (hard): natural generation but with jitter/shimmer suppressed and
  a high-band energy cap — subtle neural-vocoder-style artifacts.

``make_surrogate_corpus`` writes an ASVspoof-LA-layout FLAC tree plus a
whitespace metadata file (the exact format ``data.metadata.read_metadata``
auto-detects), so the full metadata-driven recipe — including in-repo FLAC
decode — is exercised end to end (reference/ASV_dl_func.py:63-75, :150-162).

A copy of the JAX package's ``data/synthetic.py`` (numpy and scipy only;
importing that package imports jax) that writes its FLAC files with the
port's ``io/flac.py``: for one seed both packages write the same metadata
text and the same FLAC bytes.
"""

from __future__ import annotations

import os

import numpy as np

_F1_RANGE = (280.0, 780.0)
_F2_RANGE = (900.0, 2200.0)
_F3_RANGE = (2300.0, 3000.0)

SPOOF_TIERS = ("A01", "A02", "A03")


def _smooth_walk(rng, n, lo, hi, smoothness=2000):
    """Slow random trajectory within [lo, hi]."""
    k = max(n // smoothness, 4)
    pts = rng.uniform(lo, hi, k)
    x = np.interp(np.arange(n), np.linspace(0, n - 1, k), pts)
    return x


def _resonator(x, f, bw, sr):
    """Time-invariant 2nd-order resonator (one formant)."""
    from scipy.signal import lfilter

    r = np.exp(-np.pi * bw / sr)
    theta = 2 * np.pi * f / sr
    b0 = (1 - r) * np.sqrt(1 - 2 * r * np.cos(2 * theta) + r * r)
    return lfilter([b0], [1.0, -2 * r * np.cos(theta), r * r], x)


def synth_bonafide(
    rng: np.random.Generator, n: int, sr: int, *,
    jitter: float = 0.02, shimmer: float = 0.1, hf_gain: float = 1.0,
    f0_quantize: bool = False,
) -> np.ndarray:
    """Speech-like utterance, float64 in [-1, 1]."""
    t = np.arange(n)
    f0 = _smooth_walk(rng, n, 90.0, 220.0)
    if f0_quantize:  # statistical-parametric artifact: stepped, flat F0
        f0 = np.round(f0 / 20.0) * 20.0
    if jitter > 0:  # cycle-level F0 perturbation (natural voice quality)
        f0 = f0 * (1.0 + jitter * _smooth_walk(rng, n, -1, 1, smoothness=160))
    phase = 2 * np.pi * np.cumsum(f0) / sr
    # glottal-ish source: decaying harmonic comb
    src = sum((0.9**h) * np.sin((h + 1) * phase + rng.uniform(0, 2 * np.pi))
              for h in range(12))
    if shimmer > 0:  # amplitude micro-variation
        src = src * (1.0 + shimmer * _smooth_walk(rng, n, -1, 1, smoothness=200))
    # syllabic gating ~4 Hz
    gate = np.clip(np.sin(2 * np.pi * 3.7 * t / sr + rng.uniform(0, 6.28)) * 2 + 0.8, 0, 1)
    src = src * gate + 0.02 * rng.standard_normal(n)  # breath noise floor

    # three-formant vocal tract (per-utterance random but fixed targets)
    y = np.zeros(n)
    for (lo, hi), bw in ((_F1_RANGE, 90.0), (_F2_RANGE, 120.0), (_F3_RANGE, 160.0)):
        y = y + _resonator(src, rng.uniform(lo, hi), bw, sr)
    if hf_gain != 1.0:  # neural-vocoder artifact: high-band energy cap
        from scipy.signal import butter, lfilter

        b, a = butter(4, 3500 / (sr / 2), btype="low")
        low = lfilter(b, a, y)
        y = low + hf_gain * (y - low)
    y = y / (np.abs(y).max() + 1e-9) * 0.6
    return y


def _reverb(y: np.ndarray, sr: int, rng: np.random.Generator) -> np.ndarray:
    """Sparse exponentially-decaying FIR — room/handset smearing."""
    n_taps = int(rng.integers(2, 6))
    delays = rng.integers(int(0.002 * sr), int(0.035 * sr), n_taps)
    gains = rng.uniform(0.15, 0.5, n_taps) * np.exp(-delays / (0.02 * sr))
    signs = rng.choice([-1.0, 1.0], n_taps)
    h = np.zeros(int(delays.max()) + 1)
    h[0] = 1.0
    for d, g, s in zip(delays, gains, signs):
        h[d] += s * g
    return np.convolve(y, h)[: len(y)]


def _add_noise(y: np.ndarray, rng: np.random.Generator, snr_db: float) -> np.ndarray:
    """Additive noise at the given SNR; pink-tilted half the time."""
    noise = rng.standard_normal(len(y))
    if rng.uniform() < 0.5:  # pink-ish tilt: cumulative sum, re-centred
        noise = np.cumsum(noise)
        noise = noise - noise.mean()
    p_sig = float(np.mean(y**2)) + 1e-12
    p_noise = float(np.mean(noise**2)) + 1e-12
    g = np.sqrt(p_sig / (p_noise * 10.0 ** (snr_db / 10.0)))
    return y + g * noise


def _bitcrush(y: np.ndarray, bits: int) -> np.ndarray:
    """Codec round-trip at a low bit depth. FLAC itself is lossless, so a
    write_flac/decode round-trip at depth ``bits`` IS this uniform
    requantization (same x/2^(bits-1) scaling as io/flac.py) — applied
    directly to avoid a per-utterance file round-trip."""
    q = float(1 << (bits - 1))
    return np.clip(np.round(y * q), -q, q - 1) / q


CHANNEL_PROFILES = ("varied",)


def apply_channel(
    y: np.ndarray, sr: int, rng: np.random.Generator, profile: str = "varied"
) -> np.ndarray:
    """Label-independent transmission-channel simulation (recipe v5).

    Every utterance — bonafide and spoof alike, same distribution — draws
    its channel from the corpus rng: optional reverb smearing, additive
    noise at a random SNR, optional low-bit-depth codec round-trip. This
    models the channel variation real LA data carries (the reference's
    eval partition mixes codecs/transmission, reference/ASV_dl_func.py
    metadata columns) and pulls the surrogate off its ~0.05-EER floor."""
    if profile != "varied":
        raise ValueError(f"unknown channel profile {profile!r}")
    if rng.uniform() < 0.5:
        y = _reverb(y, sr, rng)
    y = _add_noise(y, rng, snr_db=float(rng.uniform(6.0, 24.0)))
    if rng.uniform() < 0.4:
        y = _bitcrush(y, int(rng.integers(7, 11)))
    return y / (np.abs(y).max() + 1e-9) * 0.6


def _phase_randomize(y: np.ndarray, sr: int, rng: np.random.Generator) -> np.ndarray:
    """Keep the STFT magnitude, randomize phase (griffin-lim-style buzz)."""
    from scipy.signal import istft, stft

    _, _, Z = stft(y, fs=sr, nperseg=512, noverlap=384)
    mag = np.abs(Z)
    phase = rng.uniform(0, 2 * np.pi, Z.shape)
    _, out = istft(mag * np.exp(1j * phase), fs=sr, nperseg=512, noverlap=384)
    out = out[: len(y)]
    if len(out) < len(y):
        out = np.pad(out, (0, len(y) - len(out)))
    return out / (np.abs(out).max() + 1e-9) * 0.6


def _envelope_smooth(y: np.ndarray, sr: int) -> np.ndarray:
    """Over-smooth the spectral envelope (keep phase) — SPSS signature."""
    from scipy.ndimage import uniform_filter1d
    from scipy.signal import istft, stft

    _, _, Z = stft(y, fs=sr, nperseg=512, noverlap=384)
    mag = np.abs(Z)
    sm = uniform_filter1d(mag, size=9, axis=0)
    _, out = istft(sm * np.exp(1j * np.angle(Z)), fs=sr, nperseg=512, noverlap=384)
    out = out[: len(y)]
    if len(out) < len(y):
        out = np.pad(out, (0, len(y) - len(out)))
    return out / (np.abs(out).max() + 1e-9) * 0.6


def synth_spoof(rng: np.random.Generator, n: int, sr: int, tier: str) -> np.ndarray:
    if tier == "A01":
        return _phase_randomize(synth_bonafide(rng, n, sr), sr, rng)
    if tier == "A02":
        y = synth_bonafide(rng, n, sr, jitter=0.0, shimmer=0.0, f0_quantize=True)
        return _envelope_smooth(y, sr)
    if tier == "A03":
        return synth_bonafide(rng, n, sr, jitter=0.0, shimmer=0.02, hf_gain=0.4)
    raise ValueError(f"unknown spoof tier {tier!r} (use one of {SPOOF_TIERS})")


def make_surrogate_corpus(
    root: str,
    *,
    n_bonafide: int = 30,
    n_spoof_per_tier: int = 10,
    sr: int = 16000,
    seconds: float = 3.0,
    seed: int = 0,
    subset: str = "eval",
    tiers: tuple[str, ...] = SPOOF_TIERS,
    channel: str | None = None,
) -> tuple[str, str]:
    """Write an ASVspoof-LA-layout FLAC tree + metadata file.

    Returns (metadata_path, flac_dir). Deterministic for a given seed —
    rounds compare EER on literally identical audio. ``channel`` (recipe
    v5) passes every utterance through :func:`apply_channel` with the
    named profile; ``None`` keeps the clean v3/v4 corpus bit-identical.
    """
    rng = np.random.default_rng(seed)
    flac_dir = os.path.join(root, "flac")
    os.makedirs(flac_dir, exist_ok=True)
    n = int(sr * seconds)
    lines = []
    idx = 0

    from audioanalysisdetector_tpu_torch.io.flac import write_flac

    def _write(y, fid):
        if channel is not None:
            y = apply_channel(y, sr, rng, profile=channel)
        x = np.round(np.clip(y, -0.999, 0.999) * 32767).astype(np.int64)
        write_flac(os.path.join(flac_dir, fid + ".flac"), x, sr)

    # subset-prefixed ids so train/eval trees can't shadow each other when
    # several audio folders are searched (real ASVspoof ids are disjoint too)
    for _ in range(n_bonafide):
        fid = f"LA_{subset}_{idx:07d}"
        _write(synth_bonafide(rng, n, sr), fid)
        lines.append(f"LA_{seed:04d} {fid} nocodec asvspoof bonafide bonafide notrim {subset}")
        idx += 1
    for tier in tiers:
        for _ in range(n_spoof_per_tier):
            fid = f"LA_{subset}_{idx:07d}"
            _write(synth_spoof(rng, n, sr, tier), fid)
            lines.append(f"LA_{seed:04d} {fid} nocodec asvspoof {tier} spoof notrim {subset}")
            idx += 1
    meta = os.path.join(root, f"metadata_{subset}.txt")
    with open(meta, "w") as f:
        f.write("\n".join(lines) + "\n")
    return meta, flac_dir
