"""K5's tables, a float64 emulation of its arithmetic, its route predicate and its launch wiring, on the CPU.

``ops/cqcc.py::host_tables`` lays the plain path's host operators out for
the kernel (``ops/csrc/cqcc.cu``). ``_emulate`` applies those tables as the
kernel does, in float64: the direct-form half-band FIR at stride 2 (output t
at input 2t, taps summed in order, zeros past either end), each bin's filter
over its chunk-aligned support about frame centre ``m * hop`` of its level,
``re^2 + im^2`` with no sqrt, the per-utterance dB and floor, the two-weight
regrid, the log quirk and the DCT rows. It is held to ``cqcc()`` in float64.
The kernel runs on the card only (``chip_smoke.py``'s K5 phase); its launch
is driven here with a fake C entry point, as in ``tests/test_torch_lstm_scan.py``.
"""

import contextlib
import ctypes
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from audioanalysisdetector_tpu_torch import ops
from audioanalysisdetector_tpu_torch.frontend.cqcc import (
    CQCCConfig,
    _linear_regrid_matrix,
    _regrid_on,
    cqcc,
    cqcc_from_cqt_mag,
)
from audioanalysisdetector_tpu_torch.frontend.cqt import (
    CQTConfig,
    _halfband_fir,
    _octave_kernel_bank,
    _on,
    cqt,
)
from audioanalysisdetector_tpu_torch.frontend.dct import _matrix_on, dct_ii_matrix
from audioanalysisdetector_tpu_torch.models.bilstm_classifier import BiLSTMClassifier
from audioanalysisdetector_tpu_torch.models.gmm import DiagGMM
from audioanalysisdetector_tpu_torch.ops import cqcc as k5
from audioanalysisdetector_tpu_torch.score.e2e import make_cqcc_fused_scorer

torch.set_num_threads(2)
CFG = CQCCConfig()
STREAM = 0x5EED
GUARD = 64  # the kernel's zero guard either side of a level
# the emulation against cqcc() in float64: the same tables, sums in other
# orders; the log quirk's slope 2 / |interp| stays below ~1e4 on these waves
EMULATION_ATOL = 1e-10


def _wave(rows: int, n: int, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    y = 0.1 * rng.standard_normal((rows, n))
    y[0] += 0.3 * np.sin(2 * np.pi * 440.0 * np.arange(n) / 16000)  # a tone: a peaked map
    return torch.from_numpy(y.astype(np.float32))


def _emulate(y: torch.Tensor, tables: dict) -> torch.Tensor:
    """``(B, n)`` float64 waveforms -> ``(B, 19, T)``, the kernel's arithmetic."""
    n_rows, n = y.shape
    t = 1 + n // 512
    fir = torch.from_numpy(tables["fir"].astype(np.float64))
    coefs = torch.from_numpy(tables["coefs"].astype(np.float64))
    a_lo, nc, off = tables["meta"]
    oct_off, oct_len = tables["oct"]
    power = y.new_zeros(n_rows, 84, t)
    level = y
    for j in range(7):
        hop = 512 >> j
        padded = F.pad(level, (GUARD, GUARD))
        table = coefs[oct_off[j] : oct_off[j] + oct_len[j]]
        for i in range(12):
            span = 4 * int(nc[j, i])
            re = table[off[j, i] : off[j, i] + span]
            im = table[oct_len[j] // 2 + off[j, i] : oct_len[j] // 2 + off[j, i] + span]
            at = GUARD + hop * torch.arange(t)[:, None] + int(a_lo[j, i]) + torch.arange(span)[None, :]
            frames = padded[:, at]  # (B, T, span): frame m's span about its centre m * hop
            power[:, 72 - 12 * j + i] = (frames @ re) ** 2 + (frames @ im) ** 2
        if j < 6:  # y[t] = sum_i h[i] x[2t + i - 31], taps in order
            half = level.shape[-1] // 2
            xp = F.pad(level, (31, 31))
            nxt = torch.zeros_like(level[:, :half])
            for i in range(63):
                nxt = nxt + fir[i] * xp[:, i : i + 2 * half : 2]
            level = nxt
    ref = power.amax(dim=(1, 2), keepdim=True)
    db = 10.0 * torch.log10(power.clamp(min=1e-10)) - 10.0 * torch.log10(ref.clamp(min=1e-10))
    db = torch.maximum(db, db.amax(dim=(1, 2), keepdim=True) - 80.0)
    rg = torch.from_numpy(tables["regrid"])
    idx = rg[:, 0].long()
    interp = rg[:, 1, None] * db[:, idx] + rg[:, 2, None] * db[:, idx + 1]
    return torch.from_numpy(tables["dct"]) @ torch.log(interp * interp + 1e-12)


@pytest.mark.parametrize("n", [32000, 16000, 8128])
def test_the_emulation_on_the_kernels_tables_is_cqcc(n):
    """2-s clips, 1 s, and 8128 = 127 x 64 (a level-6 length of 127, no
    whole frame at the end)."""
    y = _wave(2, n, seed=n).double()
    got = _emulate(y, k5.host_tables(CFG))
    ref = cqcc(y, CFG)
    assert got.shape == ref.shape == (2, 19, 1 + n // 512)
    torch.testing.assert_close(got, ref, rtol=0, atol=EMULATION_ATOL)


def test_the_tables_are_the_host_operators():
    """The packed rows are the banks' taps over each bin's aligned span,
    every nonzero tap inside it; the regrid rows rebuild the matrix; the
    taps and the DCT rows are the plain path's."""
    t = k5.host_tables(CFG)
    a_lo, nc, off = t["meta"]
    oct_off, oct_len = t["oct"]
    assert (a_lo % 4 == 0).all() and nc.min() >= k5.MIN_PHASES and oct_len.max() <= k5.COEF_CAP
    assert (oct_off % 4 == 0).all() and (oct_len % 8 == 0).all()
    for j in range(7):
        kernels, K = _octave_kernel_bank(CFG.cqt, j)
        bank = kernels[:, 0, :]
        table = t["coefs"][oct_off[j] : oct_off[j] + oct_len[j]]
        rebuilt = np.zeros_like(bank)
        for i in range(12):
            cols = slice(K // 2 + a_lo[j, i], K // 2 + a_lo[j, i] + 4 * nc[j, i])
            rebuilt[i, cols] = table[off[j, i] : off[j, i] + 4 * nc[j, i]]
            rebuilt[12 + i, cols] = table[oct_len[j] // 2 + off[j, i] : oct_len[j] // 2 + off[j, i] + 4 * nc[j, i]]
            assert 4 * nc[j, i] - np.count_nonzero(bank[i]) <= 6  # at most 3 zero taps a side
        np.testing.assert_array_equal(rebuilt, bank)  # the taps left out are zeros (some -0.0)
    W = _linear_regrid_matrix(84, CFG.cqt.fmin, 12)
    rows, idx = np.arange(84), t["regrid"][:, 0].astype(int)
    rebuilt = np.zeros_like(W)
    rebuilt[rows, idx] = t["regrid"][:, 1]
    rebuilt[rows, idx + 1] = t["regrid"][:, 2]
    assert rebuilt.tobytes() == W.tobytes()
    assert t["fir"].tobytes() == _halfband_fir(63).tobytes()
    assert t["dct"].tobytes() == dct_ii_matrix(84, 19).tobytes()


def _refused(case: str) -> tuple[torch.Tensor, CQCCConfig]:
    y, cfg = torch.zeros(2, 32000), CFG
    if case == "float64":
        y = y.double()
    elif case == "sr22050":
        cfg = CQCCConfig.for_sr(22050)
    elif case == "ceps13":
        cfg = CQCCConfig(n_ceps=13)
    elif case == "hop256":
        cfg = CQCCConfig(cqt=CQTConfig(hop_length=256))
    elif case.startswith("n"):
        y = torch.zeros(2, int(case[1:]))
    elif case == "grad":
        y.requires_grad_(True)
    return y, cfg


@pytest.mark.parametrize(
    "case, reason",
    [("cpu", None), ("float64", "dtype"), ("sr22050", "config"), ("ceps13", "config"), ("hop256", "config"),
     ("n32001", "length"), ("n31936", None), ("n32704", None), ("n32768", "length"), ("n448", "length"),
     ("n512", None), ("grad", "grad")],
)
def test_route_refuses(case, reason):
    """A CPU tensor always has ``device``; each other reason beside it. The
    longest length the shared-memory plan holds is 32,704 (T = 64)."""
    y, cfg = _refused(case)
    assert k5.refusals(y, cfg) == ["device"] + ([reason] if reason else [])
    assert not k5.takes(y, cfg)


def test_route_needs_no_grad_under_inference_mode():
    y = torch.zeros(2, 32000, requires_grad=True)
    assert "grad" in k5.refusals(y, CFG)
    with torch.no_grad():
        assert k5.refusals(y, CFG) == ["device"]
    with torch.inference_mode():
        assert k5.refusals(torch.zeros(2, 32000), CFG) == ["device"]


@pytest.mark.parametrize("shape", [(3, 32000), (2, 2, 16000), (8128,)])
def test_cpu_cqcc_is_the_plain_chain_bit_for_bit(shape):
    """On a CPU tensor ``cqcc()`` is the plain chain it always was, and no
    kernel launches."""
    y = _wave(int(np.prod(shape[:-1], dtype=int)), shape[-1], seed=len(shape)).reshape(shape)
    ops.reset_launch_counts()
    got = cqcc(y, CFG)
    assert ops.launch_counts()["cqcc"] == 0
    assert torch.equal(got, cqcc_from_cqt_mag(cqt(y, CFG.cqt), CFG))


def test_the_plain_chain_takes_grad_after_an_inference_call():
    """The plain chain's cached operators are normal tensors even when an
    ``inference_mode`` call built them, so a later input that requires grad
    (which the route refuses to K5) still gets its backward."""
    for cached in (_on, _regrid_on, _matrix_on):
        cached.cache_clear()
    y = _wave(2, 16000, seed=5).double()
    with torch.inference_mode():
        first = cqcc(y, CFG)
    y.requires_grad_(True)
    again = cqcc(y, CFG)
    again.sum().backward()
    assert torch.equal(first, again.detach())
    assert y.grad is not None and bool(torch.isfinite(y.grad).all()) and float(y.grad.abs().sum()) > 0


class FakeEntry:
    """The C entry point: records its arguments and returns 0."""

    def __init__(self):
        self.calls = []

    def __call__(self, *args) -> int:
        self.calls.append(args)
        return 0


@pytest.fixture
def fake_card(monkeypatch):
    """K5's launch without a card: the tensors stay on the CPU, the wrapper
    takes them for card tensors, and the entry point is ``FakeEntry``."""
    entry = FakeEntry()
    monkeypatch.setattr(k5, "on_card", lambda x, kernel: True)
    monkeypatch.setattr(k5._build, "entry_point", lambda *args: entry)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: SimpleNamespace(cuda_stream=STREAM))
    ops.reset_launch_counts()
    yield entry
    ops.reset_launch_counts()


@pytest.mark.parametrize("shape", [(5, 32000), (2, 3, 16000)])
def test_launch_hands_the_kernel_its_tables_and_counts_once(fake_card, shape):
    y = torch.zeros(shape)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = k5.cqcc_kernel(y, CFG)
    n, rows = shape[-1], int(np.prod(shape[:-1]))
    assert out.shape == (*shape[:-1], 19, 1 + n // 512)
    (args,) = fake_card.calls
    coefs, regrid, dct = k5._device_tables(CFG, y.device)
    host = k5.host_tables(CFG)
    assert args == (
        y.data_ptr(), rows, n, coefs.data_ptr(), regrid.data_ptr(), dct.data_ptr(), host["fir"].ctypes.data,
        host["meta"].ctypes.data, host["oct"].ctypes.data, out.data_ptr(), STREAM,
    )
    assert coefs.dtype == regrid.dtype == dct.dtype == torch.float32
    assert ops.launch_counts() == {**dict.fromkeys(ops.LAUNCH_COUNTERS, 0), "cqcc": 1}
    names = [e.name() for e in prof.profiler.kineto_results.events() if e.is_user_annotation()]
    assert names.count("cqcc.kernel") == 1


def test_launch_copies_a_strided_or_misaligned_input(fake_card):
    base = torch.zeros(2, 32001)
    for y in (base[:, 1:], torch.zeros(2, 64000)[:, ::2]):  # 4 bytes off alignment; strided
        k5.cqcc_kernel(y, CFG)
        ptr = fake_card.calls[-1][0]
        assert ptr % 16 == 0 and ptr not in (y.data_ptr(), base.data_ptr())


def test_launch_refuses_grad_and_an_empty_batch_launches_nothing(fake_card):
    with pytest.raises(RuntimeError, match=r"cqcc: .*no backward"):
        k5.cqcc_kernel(torch.zeros(2, 32000, requires_grad=True), CFG)
    assert k5.cqcc_kernel(torch.zeros(0, 32000), CFG).shape == (0, 19, 63)
    with pytest.raises(ValueError, match="cannot take this input: length"):
        k5.cqcc_kernel(torch.zeros(2, 32001), CFG)
    assert fake_card.calls == [] and ops.launch_counts()["cqcc"] == 0


def test_the_fused_scorer_reaches_the_kernel_inside_its_frontend_span(fake_card, monkeypatch):
    """Where ``takes`` holds, ``cqcc()`` is one launch: in the fused scorer,
    one ``cqcc.kernel`` span inside ``score.frontend`` a call. The fake entry
    point writes zeros, as a kernel would write its CQCC."""
    monkeypatch.setattr(k5, "takes", lambda y, cfg: True)

    def zeros(*args) -> int:
        fake_card.calls.append(args)
        ctypes.memset(args[9], 0, args[1] * 19 * (1 + args[2] // 512) * 4)
        return 0

    monkeypatch.setattr(k5._build, "entry_point", lambda *args: zeros)
    torch.manual_seed(0)
    gmm = lambda shift: DiagGMM(torch.full((4,), 0.25), torch.randn(4, 19) + shift, torch.ones(4, 19))  # noqa: E731
    score = make_cqcc_fused_scorer(BiLSTMClassifier(hidden=8), gmm(0.0), gmm(0.5), CFG)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            out = score(_wave(3, 32000, seed=1))
    assert out.shape == (3,) and bool(torch.isfinite(out).all())
    assert len(fake_card.calls) == 2 and ops.launch_counts()["cqcc"] == 2
    spans = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
             for e in prof.profiler.kineto_results.events() if e.is_user_annotation()]
    fronts = [sp for sp in spans if sp[0] == "score.frontend"]
    kernels = [sp for sp in spans if sp[0] == "cqcc.kernel"]
    assert len(fronts) == len(kernels) == 2
    assert all(any(f[1] <= k[1] and k[2] <= f[2] for f in fronts) for k in kernels)
