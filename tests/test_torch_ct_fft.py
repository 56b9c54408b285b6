"""K3's FFT plan (``ops/csrc/ct_mel.cu``), emulated step by step on the CPU.

The CUDA kernel cannot run here. These tests replay its data plan in torch
float32: lane ``a`` and register ``b`` of the packed frame, the two passes
of in-register 32-point radix-2 DIF FFTs with their bit-reversed outputs,
the ``W_1024^(a c)`` twiddle and the transpose, the real split with its
shuffle partners, ``|X|^2`` and the mel pairs. The operands are the host
tables of ``ops/ct_mel.py::_kernel_operands`` and the ``W_32`` literals read
from the CUDA source. The emulation is held to the JAX Pallas kernel in
interpret mode and to the port's plain ``ct_mel_reference``; the kernel
itself is held to the same plain version on the card by ``chip_smoke.py``.
"""

import re
from functools import lru_cache
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import audioanalysisdetector_tpu.frontend.mel as jmel
from audioanalysisdetector_tpu.ops.ct_mel import ct_mel as j_ct_mel
from audioanalysisdetector_tpu_torch.frontend import mel as tmel
from audioanalysisdetector_tpu_torch.frontend.stft import center_pad
from audioanalysisdetector_tpu_torch.ops import ct_mel as tct

torch.set_num_threads(2)
CPU = torch.device("cpu")
R = 32  # radix of both passes == lanes == registers
SOURCE = Path(tct.__file__).parent / "csrc" / "ct_mel.cu"
# the emulated plan against the JAX kernel and the plain version, relative to
# each utterance's max mel power: fp32 FFT rounding grows with log2 N, the
# direct sums of the references with sqrt N; the bound of
# tests/test_torch_mel_core.py, 5x under chip_smoke.py's REL_TOL
PLAN_TOL = 2e-5


def brev5(j: int) -> int:
    return int(f"{j:05b}"[::-1], 2)


@lru_cache(maxsize=None)
def cos_q() -> tuple[float, ...]:
    """The kernel's float literals cos(pi e / 16), e = 0..8, from its source."""
    body = re.search(r"constexpr float cos_q\(int e\) \{(.*?)\}", SOURCE.read_text(), re.S).group(1)
    vals = dict((int(e), float(v)) for e, v in re.findall(r"e == (\d) \? ([0-9.]+)f", body))
    vals[8] = float(re.search(r": ([0-9.]+)f;", body).group(1))
    return tuple(vals[e] for e in range(9))


def w32(e: int) -> tuple[float, float]:
    """W_32^e, e = 0..15, from the literals as the kernel's w32r / w32i."""
    c = cos_q()
    return (c[e] if e <= 8 else -c[16 - e]), (-c[8 - e] if e <= 8 else -c[e - 8])


def fft32(re_: list, im: list) -> None:
    """The kernel's in-register DIF FFT over 32 registers (each a tensor),
    in place: natural order in, register j holds bin brev5(j)."""
    span = R
    while span >= 2:
        h = span // 2
        for base in range(0, R, span):
            for j in range(h):
                p, q, e = base + j, base + j + h, j * (R // span)
                dr, di = re_[p] - re_[q], im[p] - im[q]
                re_[p], im[p] = re_[p] + re_[q], im[p] + im[q]
                if e == 0:
                    re_[q], im[q] = dr, di
                elif e == 8:
                    re_[q], im[q] = di, -dr
                else:
                    wr, wi = (torch.tensor(v, dtype=torch.float32) for v in w32(e))
                    re_[q], im[q] = dr * wr - di * wi, dr * wi + di * wr
        span = h


def partner(lane: int, j: int) -> tuple[int, int]:
    """(source lane, source register) of the split partner of register j."""
    if lane == 0:
        return 0, brev5((R - brev5(j)) % R)
    return (R - lane) % R, R - 1 - j


def lane_filters(lane: int, n_mels: int) -> list[int]:
    """The filters lane ``lane`` sums, in the kernel's order: m = lane, lane +
    32, ... below ceil(n_mels / 2), each followed by its mirror."""
    out = []
    for firsts, seconds in tct.mel_lanes(n_mels):
        if lane < len(firsts):
            out += [m for m in (firsts[lane], seconds[lane]) if m >= 0]
    return out


def emulate(wp: torch.Tensor, cfg: tmel.MelConfig, n_frames: int) -> torch.Tensor:
    """The kernel's plan on (B, n_pad) center-padded float32 waveforms ->
    (B, n_frames, n_mels) mel power."""
    win, tw1, tw2, melw, spans = tct._kernel_operands(cfg, CPU)
    B = wp.shape[0]
    frames = wp.unfold(-1, 2048, cfg.hop_length)[:, :n_frames].reshape(-1, 2048)
    # lane a, register b: z[a + 32 b] = (x[2a + 64b], x[2a + 64b + 1]) * window pair
    x = (frames * win).reshape(-1, R, R, 2)  # (rows, b, a, pair)
    re_ = [x[:, b, :, 0] for b in range(R)]  # each (rows, lanes)
    im = [x[:, b, :, 1] for b in range(R)]
    fft32(re_, im)
    tile_r = torch.empty(frames.shape[0], R, R)  # [row, c, a]
    tile_i = torch.empty(frames.shape[0], R, R)
    for j in range(R):
        c = brev5(j)
        t = tw1[c]  # (a, 2)
        tile_r[:, c] = re_[j] * t[:, 0] - im[j] * t[:, 1]
        tile_i[:, c] = re_[j] * t[:, 1] + im[j] * t[:, 0]
    re_ = [tile_r[:, :, a] for a in range(R)]  # lane c reads tile[c][a] into register a
    im = [tile_i[:, :, a] for a in range(R)]
    fft32(re_, im)
    lanes = torch.arange(R)
    power = torch.empty(frames.shape[0], 1025)
    for j in range(R):
        d = brev5(j)
        pr = torch.stack([re_[partner(c, j)[1]][:, partner(c, j)[0]] for c in range(R)], dim=1)
        pi = torch.stack([im[partner(c, j)[1]][:, partner(c, j)[0]] for c in range(R)], dim=1)
        k = lanes + R * d
        w = tw2[k]
        ar, ai = 0.5 * (re_[j] + pr), 0.5 * (im[j] - pi)
        br, bi = 0.5 * (re_[j] - pr), 0.5 * (im[j] + pi)
        xr = ar + (w[:, 0] * bi + w[:, 1] * br)
        xi = ai - (w[:, 0] * br - w[:, 1] * bi)
        power[:, k] = xr * xr + xi * xi
    power[:, 1024] = (re_[0][:, 0] - im[0][:, 0]) ** 2
    lo, hi, row = spans.tolist()
    out = torch.empty(frames.shape[0], cfg.n_mels)
    for lane in range(R):
        for m in lane_filters(lane, cfg.n_mels):
            # weight of bin k at melw[row + k - lo, lane]
            out[:, m] = power[:, lo[m] : hi[m]] @ melw[row[m] : row[m] + hi[m] - lo[m], lane]
    return out.reshape(B, n_frames, cfg.n_mels)


def _padded(case: str, batch: int = 8, n: int = 32000) -> np.ndarray:
    rng = np.random.default_rng(len(case))
    if case == "silence":
        y = np.zeros((batch, n), np.float32)
    else:
        y = rng.standard_normal((batch, n)) * 0.1
        if case == "loud_and_quiet":  # 60 dB between utterances, a 1 kHz tone in one
            y *= np.logspace(0, -3, batch)[:, None]
            y[0] += np.sin(2 * np.pi * 1000 * np.arange(n) / 16000)
    return center_pad(torch.from_numpy(y.astype(np.float32)), 2048).contiguous().numpy()


def _rel(got: np.ndarray, ref: np.ndarray) -> float:
    peak = np.abs(ref).max(axis=(1, 2), keepdims=True)
    return float((np.abs(got - ref) / np.maximum(peak, 1e-30)).max())


@pytest.mark.parametrize(
    "case, n_mels",
    [("noise", 64), ("loud_and_quiet", 64), ("silence", 64), ("noise", 128), ("noise", 63)],
)
def test_plan_matches_jax_kernel_and_plain(case, n_mels):
    wp = _padded(case)
    tcfg = tmel.MelConfig(n_mels=n_mels)
    got = emulate(torch.from_numpy(wp), tcfg, 63).numpy()
    plain = tct.ct_mel_reference(torch.from_numpy(wp), tcfg, n_frames=63).numpy()
    jax_ref = np.asarray(j_ct_mel(jnp.asarray(wp), jmel.MelConfig(n_mels=n_mels), n_frames=63,
                                  interpret=True))
    assert got.shape == plain.shape == jax_ref.shape == (8, 63, n_mels)
    assert np.isfinite(got).all()
    if case == "silence":
        assert not got.any()
    assert _rel(got, plain) < PLAN_TOL
    assert _rel(got, jax_ref) < PLAN_TOL


def test_fft32_registers_hold_bit_reversed_bins():
    rng = np.random.default_rng(0)
    z = (rng.standard_normal((3, R)) + 1j * rng.standard_normal((3, R))).astype(np.complex64)
    re_ = [torch.from_numpy(z[:, b].real.copy()) for b in range(R)]
    im = [torch.from_numpy(z[:, b].imag.copy()) for b in range(R)]
    fft32(re_, im)
    ref = np.fft.fft(z.astype(np.complex128), axis=-1)
    for j in range(R):
        got = re_[j].double().numpy() + 1j * im[j].double().numpy()
        np.testing.assert_allclose(got, ref[:, brev5(j)], rtol=0, atol=1e-5)


def test_host_tables_are_float64_formulas_rounded_bitwise():
    cfg = tmel.MelConfig()
    win, tw1, tw2, melw, spans = tct._kernel_operands(cfg, CPU)
    ac = np.outer(np.arange(R), np.arange(R))
    exp1 = np.exp(-2j * np.pi * (ac % 1024) / 1024)
    exp2 = np.exp(-2j * np.pi * np.arange(1025) / 2048)
    for table, ref in ((tw1, exp1), (tw2, exp2)):
        assert table.dtype == torch.float32
        np.testing.assert_array_equal(table[..., 0].numpy(), ref.real.astype(np.float32))
        np.testing.assert_array_equal(table[..., 1].numpy(), ref.imag.astype(np.float32))
    # the W_32 literals of the source: float32 of sin(pi (8 - e) / 16)
    ref = [np.float32(np.sin(np.pi * (8 - e) / 16)) for e in range(9)]
    assert [np.float32(v) for v in cos_q()] == ref
    assert cos_q()[0] == 1.0 and cos_q()[8] == 0.0


def test_partner_map_takes_every_bin_once():
    seen = []
    for lane in range(R):
        for j in range(R):
            k = lane + R * brev5(j)
            src_lane, src_reg = partner(lane, j)
            kp = src_lane + R * brev5(src_reg)
            assert kp == (1024 - k) % 1024
            if 1 <= k <= 1023:
                seen.append(kp)
    assert sorted(seen) == list(range(1, 1024))


@pytest.mark.parametrize("n_mels", [64, 128, 63, 40])
def test_mel_pairing_covers_each_filter_once(n_mels):
    taken = [m for lane in range(R) for m in lane_filters(lane, n_mels)]
    assert sorted(taken) == list(range(n_mels))
    for lane in range(R):  # the kernel's loop: m = lane, lane + 32, ..., then n_mels - 1 - m
        firsts = range(lane, (n_mels + 1) // 2, R)
        assert lane_filters(lane, n_mels) == [
            x for m in firsts for x in ([m] if n_mels - 1 - m == m else [m, n_mels - 1 - m])
        ]
    per_lane = [len(lane_filters(lane, n_mels)) for lane in range(R)]
    assert max(per_lane) - min(per_lane) <= 2


@pytest.mark.parametrize("n_mels", [64, 128, 63])
def test_mel_weight_rows_are_shared_by_the_lanes_of_a_step(n_mels):
    """Filters the lanes take together share one row base, and the row
    ranges of different such sets do not overlap: each step of the kernel's
    mel loop reads one 128-byte row of ``melw``."""
    _, _, _, melw, spans = tct._kernel_operands(tmel.MelConfig(n_mels=n_mels), CPU)
    lo, hi, row = spans.numpy()
    ranges = []
    for rnd in tct.mel_lanes(n_mels):
        for part in rnd:
            ms = [m for m in part if m >= 0]
            assert len({int(row[m]) for m in ms}) == 1
            ranges.append((int(row[ms[0]]), int(row[ms[0]]) + int(max(hi[ms] - lo[ms]))))
    ranges.sort()
    assert all(a1 <= b0 for (_, a1), (b0, _) in zip(ranges, ranges[1:]))
    assert ranges[-1][1] == melw.shape[0] and melw.shape[1] == R
