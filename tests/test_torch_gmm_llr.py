"""K6's tables, a float64 emulation of its arithmetic, its route predicate and its launch wiring, on the CPU.

``ops/csrc/gmm_llr.cu`` builds each GMM's tables in its prologue (``a =
-0.5 log2(e) / var``, ``b = log2(e) mu / var``, ``c = log2(e) (log w - 0.5
(D log 2pi + sum log var + sum mu^2 / var))``, K padded to its chunk with
``c = -inf``, D to a multiple of 4 with zeros). ``_emulate`` applies them as
the kernel does, in float64: ``c + sum_d x_d (x_d a_d + b_d)`` in index
order, the logsumexp online over chunks in base 2, the mask from each
frame's sum in index order, each utterance's masked sum over its lanes'
frames and then by xor shuffles, times ln 2 over the count. It is held to
``masked_llr`` of ``padding_mask``, K6's plain version, in float64. The
kernel's chunk and lane plan are read from its source. The kernel runs on
the card only (``chip_smoke.py``'s K6 phase); its launch is driven here
with a fake C entry point, as in ``tests/test_torch_cqcc_kernel.py``.
"""

import contextlib
import ctypes
import math
import re
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from audioanalysisdetector_tpu_torch import ops
from audioanalysisdetector_tpu_torch.models.bilstm_classifier import BiLSTMClassifier
from audioanalysisdetector_tpu_torch.models.gmm import DiagGMM, log_weighted, masked_llr
from audioanalysisdetector_tpu_torch.ops import _build
from audioanalysisdetector_tpu_torch.ops import gmm_llr as k6
from audioanalysisdetector_tpu_torch.score.fused import arm_scores, make_arm_scorer, make_fused_scorer, padding_mask

torch.set_num_threads(2)
STREAM = 0x5EED
LOG2E = 1.0 / math.log(2.0)
_SOURCE = (_build.CSRC / "gmm_llr.cu").read_text()


def _plan(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", _SOURCE).group(1))


CHUNK, HALVES, FRAMES = _plan("C"), _plan("HALVES"), _plan("F")  # components a chunk; utterances a warp; frames a lane
LANES = 32 // HALVES
SPAN = LANES * FRAMES  # frames of an utterance a pass covers
# the emulation against masked_llr in float64: the same mathematics, the
# expansion's terms and the logsumexp in other orders and in base 2
EMULATION_ATOL = 1e-11


def _gmm(k: int, d: int, seed: int) -> DiagGMM:
    """A float32 GMM as the card holds one: Dirichlet weights, normal means,
    variances in [0.5, 1.5)."""
    rng = np.random.default_rng(seed)
    return DiagGMM(
        torch.from_numpy(rng.dirichlet(np.ones(k)).astype(np.float32)),
        torch.from_numpy(rng.standard_normal((k, d)).astype(np.float32)),
        torch.from_numpy(rng.uniform(0.5, 1.5, (k, d)).astype(np.float32)),
    )


def _double(g: DiagGMM) -> DiagGMM:
    return DiagGMM(g.weights.double(), g.means.double(), g.variances.double())


def _frames(b: int, t: int, d: int, seed: int, lengths=None) -> torch.Tensor:
    """Standard normal float32 frames, zero past each row's length."""
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal((b, t, d)).astype(np.float32))
    if lengths is not None:
        x = x * (torch.arange(t)[None, :] < torch.tensor(lengths)[:, None])[..., None]
    return x


def _tables(g: DiagGMM, dp: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K6's prologue in float64: ``a``, ``b`` (Kp, DP) and ``c`` (Kp,)."""
    w, mu, var = (t.double() for t in (g.weights, g.means, g.variances))
    k, d = mu.shape
    kp = -(-k // CHUNK) * CHUNK
    a = torch.zeros(kp, dp, dtype=torch.float64)
    b = torch.zeros(kp, dp, dtype=torch.float64)
    c = torch.full((kp,), -math.inf, dtype=torch.float64)
    a[:k, :d] = -0.5 * LOG2E / var
    b[:k, :d] = LOG2E * mu / var
    c[:k] = LOG2E * (torch.log(w) - 0.5 * (d * math.log(2 * math.pi) + torch.log(var).sum(-1) + (mu * mu / var).sum(-1)))
    return a, b, c


def _log2_likelihood(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``(..., DP)`` -> ``(...)``: chunk by chunk, each component's ``c +
    sum_d x_d (x_d a_d + b_d)``, the chunk's max, one rescale of the running
    sum, then its terms in order (a chunk whose max is -inf changes nothing)."""
    m = torch.full(x.shape[:-1], -math.inf, dtype=torch.float64)
    s = torch.zeros(x.shape[:-1], dtype=torch.float64)
    for k0 in range(0, len(c), CHUNK):
        acc = c[k0 : k0 + CHUNK].expand(*x.shape[:-1], CHUNK)
        for d in range(x.shape[-1]):
            xd = x[..., d, None]
            acc = acc + xd * (xd * a[k0 : k0 + CHUNK, d] + b[k0 : k0 + CHUNK, d])
        mc = torch.maximum(m, acc.amax(-1))
        tot = s * torch.exp2(m - mc)
        for i in range(CHUNK):
            tot = tot + torch.exp2(acc[..., i] - mc)
        live = mc > -math.inf
        s, m = torch.where(live, tot, s), torch.where(live, mc, m)
    return m + torch.log2(s)


def _emulate(x: torch.Tensor, spoof: DiagGMM, genuine: DiagGMM) -> tuple[torch.Tensor, torch.Tensor]:
    """``(B, T, D)`` frames -> ``(llr (B,), empty (B,))``, K6's arithmetic in float64."""
    n, t_len, d = x.shape
    dp = -(-d // 4) * 4
    xp = F.pad(x.double(), (0, dp - d))
    tot = torch.zeros(n, t_len, dtype=torch.float64)
    for i in range(dp):
        tot = tot + xp[..., i]
    valid = tot != 0
    diff = _log2_likelihood(xp, *_tables(spoof, dp)) - _log2_likelihood(xp, *_tables(genuine, dp))
    # lane l of an utterance holds frames t0 + l + LANES f of each pass
    lane_sum = torch.zeros(n, LANES, dtype=torch.float64)
    lane_count = torch.zeros(n, LANES, dtype=torch.int64)
    for t0 in range(0, t_len, SPAN):
        for f in range(FRAMES):
            t = t0 + torch.arange(LANES) + LANES * f
            held = (t < t_len) & valid[:, t.clamp(max=t_len - 1)]
            lane_sum = lane_sum + torch.where(held, diff[:, t.clamp(max=t_len - 1)], 0.0)
            lane_count = lane_count + held
    o = LANES // 2
    while o:
        partner = torch.arange(LANES) ^ o
        lane_sum, lane_count = lane_sum + lane_sum[:, partner], lane_count + lane_count[:, partner]
        o //= 2
    count = lane_count[:, 0]
    return math.log(2.0) * lane_sum[:, 0] / count.clamp(min=1), count == 0


def _plain(x: torch.Tensor, spoof: DiagGMM, genuine: DiagGMM) -> tuple[torch.Tensor, torch.Tensor]:
    """K6's plain version in float64: ``arm_scores``' GMM arm."""
    x = x.double()
    mask = padding_mask(x)
    return masked_llr(x, mask, _double(spoof), _double(genuine)), mask.sum(-1) == 0


@pytest.mark.parametrize("k, d", [(128, 19), (13, 19), (20, 32), (8, 1), (256, 4)])
def test_tables_are_the_log_weighted_densities(k, d):
    """``c + sum_d x_d (x_d a_d + b_d)`` is ``log2(e) (log w + log p_k(x))``
    for every real component; the padding rows read -inf."""
    g = _gmm(k, d, seed=k + d)
    dp = -(-d // 4) * 4
    a, b, c = _tables(g, dp)
    x = F.pad(torch.randn(50, d, dtype=torch.float64, generator=torch.Generator().manual_seed(3)), (0, dp - d))
    got = c + (x[:, None, :] * (x[:, None, :] * a + b)).sum(-1)
    torch.testing.assert_close(got[:, :k], LOG2E * log_weighted(x[:, :d], _double(g)), rtol=0, atol=1e-12)
    assert len(c) % CHUNK == 0 and bool((got[:, k:] == -math.inf).all())


_CASES = {  # name: (B, T, D, K spoof, K genuine, lengths)
    "all_valid": (3, 63, 19, 128, 128, None),
    "padded_tails": (4, 63, 19, 128, 128, [63, 40, 17, 1]),
    "empty_row": (3, 63, 19, 128, 128, [63, 0, 30]),
    "k_not_a_chunk": (2, 63, 19, 13, 20, [63, 50]),
    "t_above_a_pass": (3, 150, 19, 24, 16, [150, 129, 64]),
    "t_below_a_lane_row": (5, 5, 19, 16, 16, [5, 3, 0, 1, 5]),
    "d32": (2, 70, 32, 16, 24, [70, 33]),
    "d1": (3, 20, 1, 8, 9, None),
}


@pytest.mark.parametrize("case", list(_CASES))
def test_the_emulation_is_the_plain_arm(case):
    b, t, d, ks, kg, lengths = _CASES[case]
    x = _frames(b, t, d, seed=b * t + d, lengths=lengths)
    spoof, genuine = _gmm(ks, d, seed=1), _gmm(kg, d, seed=2)
    llr, empty = _emulate(x, spoof, genuine)
    ref, ref_empty = _plain(x, spoof, genuine)
    torch.testing.assert_close(llr, ref, rtol=0, atol=EMULATION_ATOL)
    assert torch.equal(empty, ref_empty)
    if lengths is not None:
        assert torch.equal(empty, torch.tensor(lengths) == 0)
        assert bool((llr[empty] == 0).all())


def _refused(case: str):
    x, spoof, genuine, fn = torch.zeros(2, 63, 19), _gmm(128, 19, 1), _gmm(128, 19, 2), None
    if case == "float64":
        x = x.double()
    elif case == "gmm_float64":
        genuine = _double(genuine)
    elif case == "x2d":
        x = x[0]
    elif case == "gmm_dim":
        spoof = _gmm(128, 20, 1)
    elif case == "d33":
        x, spoof, genuine = torch.zeros(2, 63, 33), _gmm(8, 33, 1), _gmm(8, 33, 2)
    elif case == "k256":
        spoof = _gmm(256, 19, 1)
    elif case == "k257":
        genuine = _gmm(257, 19, 2)
    elif case == "feature_fn":
        fn = torch.neg
    elif case == "grad":
        x.requires_grad_(True)
    elif case == "gmm_grad":
        spoof.means.requires_grad_(True)
    return x, genuine, spoof, fn


@pytest.mark.parametrize(
    "case, reasons",
    [("cpu", []), ("float64", ["dtype"]), ("gmm_float64", ["dtype"]), ("x2d", ["shape"]), ("gmm_dim", ["shape"]),
     ("d33", ["dim"]), ("k256", []), ("k257", ["components"]), ("feature_fn", ["feature_fn"]), ("grad", ["grad"]),
     ("gmm_grad", ["grad"])],
)
def test_route_refuses(case, reasons):
    """A CPU tensor always has ``device``; each other reason beside it. The
    shared-memory plan holds D <= 32 and K <= 256."""
    args = _refused(case)
    assert k6.refusals(*args) == ["device"] + reasons
    assert not k6.takes(*args)


def test_route_needs_no_grad_under_inference_mode():
    x, genuine, spoof, _ = _refused("grad")
    assert "grad" in k6.refusals(x, genuine, spoof)
    with torch.no_grad():
        assert k6.refusals(x, genuine, spoof) == ["device"]
    with torch.inference_mode():
        assert k6.refusals(torch.zeros(2, 63, 19), genuine, spoof) == ["device"]


def test_a_gmm_on_another_device_is_refused():
    x, genuine, spoof, _ = _refused("cpu")
    meta = DiagGMM(*(p.to("meta") for p in (genuine.weights, genuine.means, genuine.variances)))
    assert k6.refusals(x, meta, spoof) == ["device"]


def test_cpu_arm_is_the_plain_path_and_launches_nothing():
    """On a CPU tensor ``arm_scores`` keeps ``padding_mask`` + ``masked_llr``
    bit for bit, and no kernel launches."""
    torch.manual_seed(0)
    model = BiLSTMClassifier(hidden=8).eval()
    x = _frames(3, 63, 19, seed=9, lengths=[63, 0, 20])
    spoof, genuine = _gmm(16, 19, 1), _gmm(16, 19, 2)
    ops.reset_launch_counts()
    with torch.inference_mode():
        _, llr, empty = arm_scores(model, genuine, spoof, x)
    assert ops.launch_counts()["gmm_llr"] == 0
    mask = padding_mask(x)
    assert torch.equal(llr, masked_llr(x, mask, spoof, genuine))
    assert torch.equal(empty, mask.sum(-1) == 0)


class FakeEntry:
    """The C entry point: records its arguments, writes ``llr`` and ``empty``
    for each row (0.25 and False, or the given ones) and returns ``rc``."""

    def __init__(self, rc: int = 0, llr: float = 0.25, empty: bool = False):
        self.rc, self.llr, self.empty, self.calls = rc, llr, empty, []

    def __call__(self, *args) -> int:
        self.calls.append(args)
        n = args[1]
        (ctypes.c_float * n).from_address(args[12])[:] = [self.llr] * n
        ctypes.memset(args[13], int(self.empty), n)
        return self.rc


@pytest.fixture
def fake_card(monkeypatch):
    """K6's launch without a card: the tensors stay on the CPU, the wrapper
    takes them for card tensors, the route drops ``device`` from its
    reasons, and the entry point is ``FakeEntry``."""
    entry = FakeEntry()
    plain_refusals = k6.refusals
    monkeypatch.setattr(k6, "on_card", lambda x, kernel: True)
    monkeypatch.setattr(k6, "refusals", lambda *args: [r for r in plain_refusals(*args) if r != "device"])
    monkeypatch.setattr(k6._build, "entry_point", lambda *args: entry)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: SimpleNamespace(cuda_stream=STREAM))
    ops.reset_launch_counts()
    yield entry
    ops.reset_launch_counts()


def _user_spans(prof) -> list[tuple[str, int, int]]:
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events() if e.is_user_annotation()]


@pytest.mark.parametrize("b, t, ks, kg", [(5, 63, 128, 128), (3, 150, 13, 256)])
def test_launch_hands_the_kernel_its_operands_and_counts_once(fake_card, b, t, ks, kg):
    x = _frames(b, t, 19, seed=4)
    spoof, genuine = _gmm(ks, 19, 1), _gmm(kg, 19, 2)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        llr, empty = k6.gmm_llr(x, spoof, genuine)
    assert llr.shape == empty.shape == (b,) and llr.dtype == torch.float32 and empty.dtype == torch.bool
    (args,) = fake_card.calls
    assert args == (
        x.data_ptr(), b, t, 19,
        spoof.weights.data_ptr(), spoof.means.data_ptr(), spoof.variances.data_ptr(), ks,
        genuine.weights.data_ptr(), genuine.means.data_ptr(), genuine.variances.data_ptr(), kg,
        llr.data_ptr(), empty.data_ptr(), STREAM,
    )
    assert bool((llr == 0.25).all()) and not bool(empty.any())
    assert ops.launch_counts() == {**dict.fromkeys(ops.LAUNCH_COUNTERS, 0), "gmm_llr": 1}
    assert _user_spans(prof) == []  # the launch opens no span: its caller's fused.gmm covers it


def test_launch_copies_strided_operands(fake_card):
    x = _frames(2, 63, 38, seed=5)[..., ::2]
    spoof = _gmm(16, 19, 1)
    genuine = DiagGMM(spoof.weights, spoof.means.t().contiguous().t(), spoof.variances)
    k6.gmm_llr(x, spoof, genuine)
    args = fake_card.calls[-1]
    assert args[0] != x.data_ptr() and args[9] != genuine.means.data_ptr()


def test_a_failed_launch_raises_and_is_not_counted(fake_card, monkeypatch):
    monkeypatch.setattr(k6._build, "entry_point", lambda *args: FakeEntry(rc=700))
    with pytest.raises(RuntimeError, match="gmm_llr kernel launch failed with CUDA error 700"):
        k6.gmm_llr(_frames(2, 63, 19, seed=6), _gmm(16, 19, 1), _gmm(16, 19, 2))
    assert ops.launch_counts()["gmm_llr"] == 0


def test_launch_refuses_grad_and_bad_shapes_and_an_empty_batch_launches_nothing(fake_card):
    spoof, genuine = _gmm(16, 19, 1), _gmm(16, 19, 2)
    with pytest.raises(RuntimeError, match=r"gmm_llr: .*no backward"):
        k6.gmm_llr(_frames(2, 63, 19, seed=7).requires_grad_(True), spoof, genuine)
    spoof.variances.requires_grad_(True)
    with pytest.raises(RuntimeError, match=r"gmm_llr: .*no backward"):
        k6.gmm_llr(_frames(2, 63, 19, seed=7), spoof, genuine)
    spoof.variances.requires_grad_(False)
    with pytest.raises(ValueError, match="cannot take this input: shape"):
        k6.gmm_llr(_frames(2, 63, 20, seed=7), spoof, genuine)
    llr, empty = k6.gmm_llr(torch.zeros(0, 63, 19), spoof, genuine)
    assert llr.shape == empty.shape == (0,)
    assert fake_card.calls == [] and ops.launch_counts()["gmm_llr"] == 0


def test_the_cpu_wrapper_raises():
    with pytest.raises(ValueError, match="runs on the card"):
        k6.gmm_llr(torch.zeros(2, 63, 19), _gmm(8, 19, 1), _gmm(8, 19, 2))


def test_the_fused_scorer_reaches_the_kernel_inside_its_gmm_span(fake_card, monkeypatch):
    """Where ``takes`` holds, the GMM arm is one launch inside ``fused.gmm``
    inside ``score.model``; its ``llr`` and ``empty`` are the arm's. With a
    ``gmm_feature_fn`` the arm takes the plain path and launches nothing."""
    torch.manual_seed(0)
    model = BiLSTMClassifier(hidden=8)
    spoof, genuine = _gmm(16, 19, 1), _gmm(16, 19, 2)
    x = _frames(3, 63, 19, seed=8)
    fake_card.empty = True

    def marked(*args):  # a range around each launch, to place it among the spans
        with torch.profiler.record_function("test.launch"):
            return fake_card(*args)

    monkeypatch.setattr(k6._build, "entry_point", lambda *args: marked)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, llr, empty = make_arm_scorer(model, genuine, spoof)(x)
        scores = make_fused_scorer(model, genuine, spoof)(x)
    assert bool((llr == 0.25).all()) and bool(empty.all())
    assert bool((scores == 0.5).all())  # every row empty: the reference's 0.5
    assert len(fake_card.calls) == 2 and ops.launch_counts()["gmm_llr"] == 2
    spans = _user_spans(prof)
    arms = [sp for sp in spans if sp[0] == "fused.gmm"]
    launches = [sp for sp in spans if sp[0] == "test.launch"]
    assert len(arms) == len(launches) == 2 and "gmm.kernel" not in [sp[0] for sp in spans]
    assert all(sum(a[1] <= k[1] and k[2] <= a[2] for k in launches) == 1 for a in arms)  # one launch each

    with torch.inference_mode():
        _, llr, _ = arm_scores(model, genuine, spoof, x, gmm_feature_fn=torch.neg)
    assert ops.launch_counts()["gmm_llr"] == 2
    torch.testing.assert_close(llr, masked_llr(-x, padding_mask(x), spoof, genuine), rtol=0, atol=0)
