"""K3's dB instance (``ops/ct_mel.py::ct_mel_db``) without a card.

The instance writes ``power_to_db(ref="max", top_db)`` of each utterance's
mel power from its epilogue (``ops/csrc/ct_mel.cu``, design step 8). Here:
its route's refusals by name, the CPU route left as it was, a float32 numpy
emulation of the epilogue's separate roundings held bitwise to
``power_to_db``, and the launch wiring with a fake entry point. The kernel
itself is held bitwise to ``ct_mel_unpadded`` + ``power_to_db`` on the card
(``tests/test_torch_ct_mel_card.py``).
"""

import contextlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from audioanalysisdetector_tpu_torch import ops
from audioanalysisdetector_tpu_torch.frontend import mel as tmel
from audioanalysisdetector_tpu_torch.frontend.db import power_to_db
from audioanalysisdetector_tpu_torch.ops import ct_mel as ctm

STREAM = 0x5EED
THREADS, WARPS = 256, 8  # the kernel's block
F32 = np.float32
CFG = tmel.MelConfig()


# --- the route's refusals -------------------------------------------------

@pytest.mark.parametrize(
    "case, reason",
    [
        ("accepted", None),
        ("float64", "dtype"),
        ("speech_profile", "config"),
        ("fft_method", "config"),
        ("not_centered", "config"),
        ("constant_pad", "config"),
        ("numeric_ref", "ref"),
        ("negative_top_db", "top_db"),
        ("nan_top_db", "top_db"),
        ("amin", "amin"),
        ("t188_at_64_mels", "tile"),
        ("256_mels", "tile"),
    ],
)
def test_each_refusal_by_name(case, reason):
    """A CPU tensor always has ``device``; each other reason beside it. The
    mel tile leaves two blocks an SM up to T * n_mels = 12,016."""
    y, cfg, kw = torch.zeros(2, 32000), CFG, {}
    if case == "float64":
        y = y.double()
    elif case == "speech_profile":
        cfg = tmel.MelConfig.for_speech()
    elif case == "fft_method":
        cfg = tmel.MelConfig(method="fft")
    elif case == "not_centered":
        cfg = tmel.MelConfig(center=False)
    elif case == "constant_pad":
        cfg = tmel.MelConfig(pad_mode="constant")
    elif case == "numeric_ref":
        kw = {"ref": 1.0}
    elif case == "negative_top_db":
        kw = {"top_db": -1.0}
    elif case == "nan_top_db":
        kw = {"top_db": float("nan")}
    elif case == "amin":
        kw = {"amin": 1e-5}
    elif case == "t188_at_64_mels":
        y = torch.zeros(2, 188 * 512 - 512)  # T = 188
    elif case == "256_mels":
        cfg = tmel.MelConfig(n_mels=256)
    assert ctm.db_refusals(y, cfg, **kw) == ["device"] + ([reason] if reason else [])


@pytest.mark.parametrize(
    "n, n_mels, top_db",
    [(32000, 64, 80.0), (16000, 64, None), (64000, 64, 0.0), (95743, 64, 80.0), (32000, 128, 80.0)],
)
def test_what_the_route_takes(n, n_mels, top_db):
    """2-s clips at 64 and 128 mels, 1- and 4-s clips, the longest tile
    (T = 187 at 64 mels), top_db None and 0."""
    assert ctm.db_refusals(torch.zeros(3, n), tmel.MelConfig(n_mels=n_mels), top_db=top_db) == ["device"]


def test_route_needs_no_grad_under_inference_mode():
    y = torch.zeros(2, 32000, requires_grad=True)
    assert ctm.db_refusals(y, CFG) == ["device", "grad"]
    with torch.no_grad():
        assert ctm.db_refusals(y, CFG) == ["device"]
    with torch.inference_mode():
        assert ctm.db_refusals(torch.zeros(2, 32000), CFG) == ["device"]


@pytest.mark.parametrize("shape, top_db", [((3, 32000), 80.0), ((2, 2, 16000), None), ((32001,), 0.0)])
def test_cpu_log_mel_is_the_plain_chain_bit_for_bit(shape, top_db):
    """On a CPU tensor ``log_mel_spectrogram`` is ``power_to_db`` of
    ``melspectrogram`` as it always was, and no kernel launches."""
    y = torch.from_numpy((np.random.default_rng(len(shape)).standard_normal(shape) * 0.1).astype(F32))
    before = ops.launch_counts()
    got = tmel.log_mel_spectrogram(y, CFG, top_db=top_db)
    assert torch.equal(got, power_to_db(tmel.melspectrogram(y, CFG), ref="max", top_db=top_db, utt_axes=2))
    assert ops.launch_counts() == before


# --- the epilogue's arithmetic --------------------------------------------

def _log10(x) -> np.ndarray:
    """log10 in float32 by torch's own function: on the card the kernel's
    ``log10f`` and torch's ``log10`` are CUDA's one accurate log10f, so the
    emulation shares the transcendental and tests the order and roundings
    around it (numpy's float32 log10 differs from torch's in the last bit)."""
    return torch.log10(torch.from_numpy(np.asarray(x, F32).copy())).numpy()


def _max_nan(a, b):
    """The kernel's ``max_nan``: a NaN on either side wins."""
    return np.where(np.isnan(a) | (a > b), a, b).astype(F32)


def _block_max(partials: np.ndarray) -> F32:
    """``block_max`` of the 256 threads' partials: xor shuffles within each
    warp, then warp 0..7's results in order."""
    v, lanes = partials.astype(F32), np.arange(THREADS)
    for o in (16, 8, 4, 2, 1):
        v = _max_nan(v, v[lanes ^ o])
    out = v[0]
    for w in range(1, WARPS):
        out = _max_nan(out, v[32 * w])
    return F32(out)


def _thread_max(values: np.ndarray) -> np.ndarray:
    """Each thread's running ``max_nan`` of the (T, n_mels) values it
    computes in step 7, from -inf: thread 32 w + lane takes frames f = w,
    w + 8, ... and the filters ``mel_lanes`` gives its lane."""
    T, M = values.shape
    lane_of = np.empty(M, int)
    for rnd in ctm.mel_lanes(M):
        for part in rnd:
            for lane, m in enumerate(part):
                if m >= 0:
                    lane_of[m] = lane
    owner = 32 * (np.arange(T)[:, None] % WARPS) + lane_of[None, :]
    partial = np.full(THREADS, -np.inf, F32)
    with np.errstate(invalid="ignore"):  # NaN propagates, as the kernel's max_nan
        np.maximum.at(partial, owner.ravel(), values.ravel())
    return partial


def db_epilogue(S: np.ndarray, top_db: float | None, *, fused: bool = False) -> np.ndarray:
    """The dB instance's arithmetic on one utterance's (T, n_mels) float32
    power: step 7's l = 10 log10(max(S, amin)) with the threads' maxima of S
    and l, then ref, the peak as max(l) - ref and the clip, each product and
    difference rounded on its own; ``fused`` instead rounds 10 log10(S) - ref
    once, as FMA contraction would."""
    S = S.astype(F32)
    amin = F32(1e-10)
    logs = _log10(_max_nan(S, amin))
    db = (F32(10) * logs).astype(F32)
    smax, lmax = _block_max(_thread_max(S)), _block_max(_thread_max(db))
    ref = F32(10) * _log10(_max_nan(smax, amin))
    if fused:
        ls = (np.float64(10) * logs.astype(np.float64) - np.float64(ref)).astype(F32)
    else:
        ls = db - ref
    if top_db is not None:
        ls = _max_nan(ls, (lmax - ref) - F32(top_db))
    return ls


def _powers(case: str, seed: int) -> np.ndarray:
    """Seeded (63, 64) mel powers over 17 decades, with the case's planted values."""
    rng = np.random.default_rng(seed)
    S = (10.0 ** rng.uniform(-14, 3, (63, 64))).astype(F32)
    if case == "ties":  # the max at several places, in several threads' strides
        S.reshape(-1)[rng.choice(S.size, 9, replace=False)] = S.max()
    elif case == "below_amin":  # zeros and values under amin beside the rest
        S.reshape(-1)[rng.choice(S.size, 600, replace=False)] = 0.0
        S.reshape(-1)[rng.choice(S.size, 600, replace=False)] = F32(3e-11)
    elif case == "silence":  # Smax < amin: every value is amin over amin
        S[:] = 0.0
        S[5, 7] = F32(1e-12)
    elif case == "nan":
        S[10, 3] = np.nan
    elif case == "tiny_range":  # everything within top_db of the peak
        S = (1.0 + rng.uniform(0, 1e-3, S.shape)).astype(F32)
    return S


@pytest.mark.parametrize("case", ["random", "ties", "below_amin", "silence", "nan", "tiny_range"])
@pytest.mark.parametrize("top_db", [80.0, 80.3, 0.0, None])
def test_epilogue_emulation_is_power_to_db_bitwise(case, top_db):
    for seed in range(3):
        S = _powers(case, seed)
        ref = power_to_db(torch.from_numpy(S)[None].transpose(-1, -2), ref="max", top_db=top_db)
        np.testing.assert_array_equal(db_epilogue(S, top_db), ref[0].transpose(-1, -2).numpy())


def test_a_contracted_subtraction_would_show():
    """The separate roundings matter: rounding 10 log10(S) - ref once
    (what FMA contraction would do) leaves ``power_to_db`` on some values."""
    S = _powers("random", 0)
    ref = power_to_db(torch.from_numpy(S)[None].transpose(-1, -2), ref="max", top_db=None)[0].transpose(-1, -2)
    assert (db_epilogue(S, None, fused=True) != ref.numpy()).any()


# --- the launch wiring ----------------------------------------------------

class FakeEntry:
    """The C entry point: records its arguments and returns 0."""

    def __init__(self):
        self.calls = []

    def __call__(self, *args) -> int:
        self.calls.append(args)
        return 0


@pytest.fixture
def fake_card(monkeypatch):
    """K3's launch without a card: the tensors stay on the CPU, the wrapper
    takes them for card tensors, and each entry point is a ``FakeEntry``
    recorded under its symbol."""
    entries = {}

    def entry_point(name, symbol, argtypes):
        entries.setdefault(symbol, (FakeEntry(), argtypes))
        return entries[symbol][0]

    monkeypatch.setattr(ctm, "on_card", lambda x, kernel: True)
    monkeypatch.setattr(ctm._build, "entry_point", entry_point)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: SimpleNamespace(cuda_stream=STREAM))
    ops.reset_launch_counts()
    yield entries
    ops.reset_launch_counts()


@pytest.mark.parametrize("shape, top_db, passed", [((5, 32000), 80.0, 80.0), ((2, 3, 16000), None, -1.0)])
def test_launch_hands_the_db_entry_its_arguments_and_counts(fake_card, shape, top_db, passed):
    y = torch.zeros(shape)
    out = ctm.ct_mel_db(y, CFG, top_db=top_db)
    n, rows, T = shape[-1], int(np.prod(shape[:-1])), 1 + shape[-1] // 512
    assert out.shape == (*shape[:-1], T, 64)
    entry, argtypes = fake_card["ct_mel_db_launch"]
    assert list(fake_card) == ["ct_mel_db_launch"]
    (args,) = entry.calls
    win, tw1, tw2, melw, spans = ctm._kernel_operands(CFG, y.device)
    assert args == (
        y.data_ptr(), win.data_ptr(), tw1.data_ptr(), tw2.data_ptr(), melw.data_ptr(), spans.data_ptr(),
        out.data_ptr(), rows * T, T, n, 1024, 512, 64, passed, STREAM,
    )
    assert len(argtypes) == len(args) and argtypes[-2].__name__ == "c_float"
    assert ops.launch_counts() == {
        **dict.fromkeys(ops.LAUNCH_COUNTERS, 0), "ct_mel": 1, "ct_mel.reflect": 1, "ct_mel.db": 1
    }


def test_log_mel_takes_the_db_route_in_melspectrograms_layout(fake_card, monkeypatch):
    """Where no refusal is named, ``log_mel_spectrogram`` is one dB launch,
    returned as ``melspectrogram`` returns K3's power: (B, n_mels, T), the
    transpose of a contiguous (B, T, n_mels)."""
    monkeypatch.setattr(ctm, "db_refusals", lambda y, cfg, **kw: [])
    got = tmel.log_mel_spectrogram(torch.zeros(4, 32000), CFG)
    assert got.shape == (4, 64, 63) and got.stride() == (63 * 64, 1, 64)
    assert list(fake_card) == ["ct_mel_db_launch"]
    assert ops.launch_counts()["ct_mel.db"] == 1


def test_db_instance_refuses_what_it_cannot_take(fake_card):
    y = torch.zeros(2, 32000)
    with pytest.raises(ValueError, match="cannot take this input: top_db"):
        ctm.ct_mel_db(y, CFG, top_db=-3.0)
    with pytest.raises(ValueError, match="cannot take this input: tile"):
        ctm.ct_mel_db(torch.zeros(2, 96000), CFG)
    with pytest.raises(RuntimeError, match="Padding size should be less"):
        ctm.ct_mel_db(torch.zeros(2, 1024), CFG)
    with pytest.raises(RuntimeError, match=r"ct_mel: .*no backward"):
        ctm.ct_mel_db(y.requires_grad_(), CFG)
    assert set(ops.launch_counts().values()) == {0}
