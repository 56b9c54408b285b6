"""The tensor-core mel core's operands and precision scheme, on the CPU.

``ops/csrc/wave_mel.cu`` (K1 ``wave_mel`` and K2 ``fused_mel_from_frames``)
computes only the live bins, reads bf16 bases that
``ops/wave_mel.py::_kernel_operands`` lays out in wgmma core matrices,
multiplies float32 operands split into three bf16 parts each (the six
products of order 2^-16 and up, fp32 sums), and contracts the power with
the fp32 mel weights over each filter's nonzero span. The card is not here, so these tests decode the operands with
the layout's own formula and emulate the kernel's arithmetic in plain
torch: bf16 rounding through ``.to(torch.bfloat16)``, every sum in fp32.
The emulation is held to the JAX Pallas kernels in interpret mode. The
kernel itself is held to its plain version on the card by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import audioanalysisdetector_tpu.frontend.mel as jmel
from audioanalysisdetector_tpu.frontend.stft import frame_signal as j_frame_signal
from audioanalysisdetector_tpu.ops.fused_logmel import fused_mel_from_frames as j_fused_mel
from audioanalysisdetector_tpu.ops.wave_mel import wave_mel as j_wave_mel
from audioanalysisdetector_tpu_torch.frontend import mel as tmel
from audioanalysisdetector_tpu_torch.frontend.stft import _rdft_bases
from audioanalysisdetector_tpu_torch.ops import fused_logmel as tfl
from audioanalysisdetector_tpu_torch.ops import wave_mel as twm

torch.set_num_threads(2)
CPU = torch.device("cpu")
# the emulated split scheme against the JAX kernels, relative to each
# utterance's (frame row's) max mel power: 5x under chip_smoke.py's REL_TOL
SPLIT_TOL = 2e-5
# the one-product bf16 emulation against the bf16 plain version: the same
# rounded operands and fp32 sums in another order
BF16_TOL = 1e-5
# a config whose filters leave bins at both ends of the spectrum empty
NARROW = dict(n_fft=400, hop_length=160, fmin=300.0, fmax=6000.0)


def _config(name: str) -> tmel.MelConfig:
    if name == "mels256":  # two groups of 128 filters
        return tmel.MelConfig.for_speech(n_mels=256)
    return tmel.MelConfig(**NARROW) if name == "narrow" else tmel.MelConfig.for_profile(name)


def _decode(flat: torch.Tensor, n: int, k: int) -> torch.Tensor:
    """(..., n * k) in K-major core matrices -> (..., n, k) float32: element
    (r, c) sits at ((r // 8) * (k // 8) + c // 8) * 64 + (r % 8) * 8 + c % 8."""
    r, c = np.arange(n)[:, None], np.arange(k)[None, :]
    idx = ((r // 8) * (k // 8) + c // 8) * 64 + (r % 8) * 8 + c % 8
    return flat.float()[..., torch.from_numpy(idx)]


def _mel_block(cfg):
    """The mel operand split into weights ``(n_groups * n_tiles, 64, cols)``
    and the spans ``(n_groups * n_tiles, cols, 2)``, row ``g * n_tiles + t``
    the block of filter group ``g`` on tile ``t``."""
    _, mel, n_tiles = twm._kernel_operands(cfg, CPU)
    cols = mel.shape[1] // (twm.N_TILE + 1)
    assert mel.shape[0] == twm.mel_groups(cfg.n_mels) * n_tiles
    weights = mel[:, : twm.N_TILE * cols].reshape(-1, twm.N_TILE, cols).numpy()
    packed = mel[:, twm.N_TILE * cols :].numpy().view(np.uint32)
    return weights, np.stack([packed & 0xFFFF, packed >> 16], axis=-1)


def _dense(cfg, split: bool):
    """The kernel's operands as dense matrices: bases ``(parts, K, n_tiles *
    128)`` (per tile, cos of its 64 bins then sin), largest part first, and
    the mel weights ``(n_tiles * 64, n_mels)``."""
    bases, _, n_tiles = twm._kernel_operands(cfg, CPU, split)
    nt, nch, parts, _ = bases.shape
    assert nt == n_tiles
    b = _decode(bases, 2 * twm.N_TILE, twm.K_CHUNK)  # (tile, chunk, part, 128, KC)
    b = b.permute(2, 1, 4, 0, 3).reshape(parts, nch * twm.K_CHUNK, nt * 2 * twm.N_TILE)
    weights, _ = _mel_block(cfg)
    # (group, tile, bin, filter) -> (tile, bin, group, filter): the groups' columns side by side
    w = weights.reshape(-1, nt, twm.N_TILE, weights.shape[-1]).transpose(1, 2, 0, 3)
    return b, torch.from_numpy(np.ascontiguousarray(w).reshape(nt * twm.N_TILE, -1)[:, : cfg.n_mels])


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _parts(a: torch.Tensor) -> list[torch.Tensor]:
    """Three bf16 parts (as float32) that sum to ``a`` exactly."""
    p0 = _bf16(a)
    p1 = _bf16(a - p0)
    return [p0, p1, _bf16(a - p0 - p1)]


def _split_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b the kernel's way: with three parts of b, a split in three on
    the fly and the six products a_i . b_j with i + j <= 2; with one part,
    one product of bf16 a."""
    if len(b) == 1:
        return _bf16(a) @ b[0]
    p = _parts(a)
    return p[1] @ b[1] + p[0] @ b[2] + p[2] @ b[0] + p[0] @ b[1] + p[1] @ b[0] + p[0] @ b[0]


def _emulate(frames: np.ndarray, cfg, split: bool = True) -> np.ndarray:
    """(N, n_fft) frames -> (N, n_mels) mel power, as the kernel computes it."""
    b, m = _dense(cfg, split)
    x = torch.zeros((len(frames), b.shape[1]))
    x[:, : cfg.n_fft] = torch.from_numpy(frames)
    y = _split_mm(x, b)
    re_im = y.reshape(len(frames), -1, 2, twm.N_TILE)
    power = (re_im[:, :, 0] ** 2 + re_im[:, :, 1] ** 2).reshape(len(frames), -1)
    return (power @ m).numpy()


def _rel(got, ref, axes):
    peak = np.maximum(np.abs(ref).max(axis=axes, keepdims=True), 1e-30)
    return float((np.abs(got - ref) / peak).max())


def _wave(batch: int, seed: int) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal((batch, 32000)) * 0.1).astype(np.float32)


@pytest.mark.parametrize("name", ["parity", "speech", "narrow"])
def test_live_span_drops_only_zero_mel_columns(name):
    cfg = _config(name)
    fb = cfg.filterbank()  # (n_mels, n_freq)
    k_lo, k_hi = twm.live_span(cfg)
    assert not fb[:, :k_lo].any() and not fb[:, k_hi:].any()
    assert fb[:, k_lo].any() and fb[:, k_hi - 1].any()
    expected = {"parity": (1, 1024), "speech": (1, 256)}
    if name in expected:
        assert (k_lo, k_hi) == expected[name]
    else:  # fmin > 0 and fmax < sr / 2 narrow it from both ends
        assert k_lo > 1 and k_hi < cfg.n_fft // 2


@pytest.mark.parametrize("name", ["parity", "speech", "narrow"])
def test_split_bases_reconstruct_the_f32_bases(name):
    cfg = _config(name)
    (hi, lo, rest), m = _dense(cfg, split=True)
    cos_b, sin_b = _rdft_bases(cfg.n_fft, cfg.window, cfg.n_fft)
    k_lo, _ = twm.live_span(cfg)
    n_tiles = hi.shape[1] // (2 * twm.N_TILE)
    bins = k_lo + np.arange(n_tiles * twm.N_TILE)
    want = np.zeros((2, hi.shape[0], len(bins)), np.float32)
    live = bins < cos_b.shape[1]
    want[0][: cfg.n_fft, live] = cos_b[:, bins[live]]
    want[1][: cfg.n_fft, live] = sin_b[:, bins[live]]
    # per tile: the cos columns of its 64 bins, then the sin columns
    want = want.reshape(2, -1, n_tiles, twm.N_TILE).transpose(1, 2, 0, 3).reshape(hi.shape)
    err = np.abs((hi + lo).numpy() - want)
    assert (err <= 2.0**-16 * np.abs(want)).all()
    np.testing.assert_array_equal((hi + lo + rest).numpy(), want)  # 3 x 8 bits: exact
    np.testing.assert_array_equal(hi.numpy(), _bf16(torch.from_numpy(want)).numpy())
    (hi_only,), _ = _dense(cfg, split=False)
    np.testing.assert_array_equal(hi_only.numpy(), hi.numpy())  # bf16 bases = the hi parts
    mel = np.zeros((len(bins), cfg.n_mels), np.float32)
    mel[live] = cfg.filterbank().T[bins[live]]
    np.testing.assert_array_equal(m.numpy(), mel)


@pytest.mark.parametrize("name", ["parity", "speech", "narrow", "mels256"])
def test_mel_spans_cover_exactly_the_nonzero_weights(name):
    """The kernel sums each filter over its tile-local span only: every
    nonzero weight lies inside, and the span ends on nonzero weights."""
    cfg = _config(name)
    weights, spans = _mel_block(cfg)
    for t in range(len(weights)):
        for m in range(weights.shape[2]):
            lo, hi = spans[t, m]
            col = weights[t, :, m]
            if not col.any():
                assert lo == hi == 0
                continue
            assert not col[:lo].any() and not col[hi:].any()
            assert col[lo] != 0 and col[hi - 1] != 0
    # and the spans add up to two filters per bin at most
    assert (spans[..., 1] - spans[..., 0]).sum() <= 2 * weights.shape[0] * weights.shape[1]


@pytest.mark.parametrize("profile", ["parity", "speech"])
def test_split_emulation_matches_pallas_wave_mel(profile):
    tcfg, jcfg = tmel.MelConfig.for_profile(profile), jmel.MelConfig.for_profile(profile)
    y = _wave(8, seed=5)
    T = 1 + y.shape[1] // tcfg.hop_length
    wp = np.pad(y, ((0, 0), (tcfg.n_fft // 2, tcfg.n_fft // 2)), mode="reflect")
    frames = torch.from_numpy(wp).unfold(-1, tcfg.n_fft, tcfg.hop_length)[:, :T]
    ours = _emulate(frames.reshape(-1, tcfg.n_fft).numpy(), tcfg).reshape(8, T, -1)
    ref = np.asarray(j_wave_mel(jnp.asarray(wp), jcfg, n_frames=T, interpret=True))
    assert ours.shape == ref.shape == (8, T, 64)
    assert _rel(ours, ref, (1, 2)) < SPLIT_TOL


@pytest.mark.parametrize("profile", ["parity", "speech"])
def test_split_emulation_matches_pallas_fused_mel(profile):
    tcfg, jcfg = tmel.MelConfig.for_profile(profile), jmel.MelConfig.for_profile(profile)
    y = _wave(2, seed=6)
    flat = np.array(j_frame_signal(jnp.asarray(y), n_fft=jcfg.n_fft, hop_length=jcfg.hop_length))
    flat = flat.reshape(-1, jcfg.n_fft)
    ours = _emulate(flat, tcfg)
    ref = np.asarray(j_fused_mel(jnp.asarray(flat), jcfg, interpret=True))
    assert ours.shape == ref.shape
    assert _rel(ours, ref, -1) < SPLIT_TOL


@pytest.mark.parametrize("profile", ["parity", "speech"])
def test_bf16_emulation_matches_the_bf16_plain_version(profile):
    cfg = tmel.MelConfig.for_profile(profile)
    frames = (np.random.default_rng(7).standard_normal((96, cfg.n_fft)) * 0.1).astype(np.float32)
    ours = _emulate(_bf16(torch.from_numpy(frames)).numpy(), cfg, split=False)
    ref = tfl.fused_mel_from_frames_reference(
        torch.from_numpy(frames), cfg, compute_dtype="bfloat16"
    ).numpy()
    assert _rel(ours, ref, -1) < BF16_TOL


def test_operands_pad_mel_columns_past_64():
    cfg = tmel.MelConfig.for_speech(n_mels=80)
    _, mel, n_tiles = twm._kernel_operands(cfg, CPU)
    assert mel.shape == (n_tiles, (twm.N_TILE + 1) * 128)
    weights, spans = _mel_block(cfg)
    k_lo, _ = twm.live_span(cfg)
    fb = cfg.filterbank().T[k_lo : k_lo + n_tiles * twm.N_TILE].astype(np.float32)
    np.testing.assert_array_equal(weights.reshape(-1, 128)[: len(fb), :80], fb)
    assert not weights[..., 80:].any() and not spans[:, 80:].any()


def test_grouped_mel_blocks_emulate_256_mels():
    """256 filters take two grid rows of 128: the grouped mel blocks,
    decoded and emulated, give JAX's 256-mel melspectrogram."""
    tcfg, jcfg = _config("mels256"), jmel.MelConfig.for_speech(n_mels=256)
    y = _wave(2, seed=9)
    T = 1 + y.shape[1] // tcfg.hop_length
    wp = np.pad(y, ((0, 0), (tcfg.n_fft // 2, tcfg.n_fft // 2)), mode="reflect")
    frames = torch.from_numpy(wp).unfold(-1, tcfg.n_fft, tcfg.hop_length)[:, :T]
    ours = _emulate(frames.reshape(-1, tcfg.n_fft).numpy(), tcfg).reshape(2, T, -1)
    ref = np.asarray(jmel.melspectrogram(jnp.asarray(y), jcfg)).transpose(0, 2, 1)
    assert ours.shape == ref.shape == (2, T, 256)
    assert _rel(ours, ref, (1, 2)) < SPLIT_TOL
