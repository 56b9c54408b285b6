"""Seeded test utterances: white noise plus a few tones at a random level.

Every row draws its level, its noise share and its tones (frequency, level,
phase) from the seed, so loud and quiet rows, flat and peaked spectra, all
meet the per-utterance dB reference. ``waves`` makes a batch on the device
in a few large calls; ``waves_np`` makes the same recipe with numpy, for
the serving clients, which send what they make and so need it on the host.
``spec`` is the traffic file's ``"audio"`` entry: ``level`` and
``noise_share`` ranges, the number of ``tones`` and their ``tone_hz``
range.
"""

from __future__ import annotations

import math

import numpy as np

def waves(rows: int, n: int, sr: int, generator, device, spec: dict):
    """``(rows, n)`` float32 utterances on ``device``, from the
    ``torch.Generator`` ``generator``."""
    import torch  # not at import: the serving clients use numpy alone

    s = spec

    def uniform(lo_hi, shape, log=False):
        lo, hi = lo_hi
        u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
        if log:
            return torch.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))
        return lo + u * (hi - lo)

    level = uniform(s["level"], (rows, 1), log=True)
    share = uniform(s["noise_share"], (rows, 1))
    out = torch.randn((rows, n), generator=generator, device=device) * (share * level)
    t = torch.arange(n, device=device, dtype=torch.float32) / sr
    for _ in range(int(s["tones"])):
        f = uniform(s["tone_hz"], (rows, 1), log=True)
        a = uniform((0.1, 1.0), (rows, 1)) * level * (1.0 - share)
        phase = uniform((0.0, 2.0 * math.pi), (rows, 1))
        out += a * torch.sin(2.0 * math.pi * f * t + phase)
    return out.clamp_(-0.999, 0.999)


def waves_np(rows: int, n: int, sr: int, seed: int, spec: dict) -> np.ndarray:
    """``(rows, n)`` int16 utterances from ``seed`` (numpy): what a client
    sends as 16-bit WAV; as float32 rows they are ``q / 32768``."""
    s = spec
    rng = np.random.default_rng(int(seed) % (1 << 63))

    def uniform(lo_hi, shape, log=False):
        lo, hi = lo_hi
        if log:
            return np.exp(rng.uniform(math.log(lo), math.log(hi), shape))
        return rng.uniform(lo, hi, shape)

    level = uniform(s["level"], (rows, 1), log=True)
    share = uniform(s["noise_share"], (rows, 1))
    out = rng.standard_normal((rows, n), dtype=np.float32) * (share * level)
    t = np.arange(n, dtype=np.float64) / sr
    for _ in range(int(s["tones"])):
        f = uniform(s["tone_hz"], (rows, 1), log=True)
        a = uniform((0.1, 1.0), (rows, 1)) * level * (1.0 - share)
        phase = uniform((0.0, 2.0 * math.pi), (rows, 1))
        out += (a * np.sin(2.0 * math.pi * f * t + phase)).astype(np.float32)
    return np.round(np.clip(out, -0.999, 0.999) * 32768.0).astype(np.int16)


def seed_generator(seed: int, device):
    """A ``torch.Generator`` on ``device`` seeded by any whole number (taken
    mod 2**63)."""
    import torch

    return torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
