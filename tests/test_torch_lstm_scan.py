"""K4's plain version, its route predicate and its launch wiring, on the CPU.

``ops/lstm_scan.py::lstm_scan_reference`` repeats the kernel's arithmetic as
a step loop; here it is held to ``torch.nn.LSTM`` in float64. The kernel
itself runs on the card only (``tests/test_torch_lstm_card.py``,
``chip_smoke.py``'s K4 phase). ``refusals`` names every reason that keeps an
input on cuDNN; a CPU tensor always has one, so each other reason is shown
beside it. The launch is driven with a fake C entry point, as in
``tests/test_torch_ops_launch.py``.
"""

import contextlib
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from audioanalysisdetector_tpu_torch import ops
from audioanalysisdetector_tpu_torch.models.bilstm_classifier import BiLSTMClassifier
from audioanalysisdetector_tpu_torch.models.lstm import BiLSTM
from audioanalysisdetector_tpu_torch.ops import lstm_scan as k4

torch.set_num_threads(2)
H = k4.HIDDEN
STREAM = 0x5EED


def _lstm(i: int, seed: int = 0) -> torch.nn.LSTM:
    torch.manual_seed(seed)
    return torch.nn.LSTM(i, H, batch_first=True, bidirectional=True).double()


def _x(t: int, i: int, rows: int = 3, dtype=torch.float64) -> torch.Tensor:
    return torch.randn(rows, t, i, generator=torch.Generator().manual_seed(t * 1000 + i), dtype=dtype)


@pytest.mark.parametrize("t", [1, 2, 63])
@pytest.mark.parametrize("i", [19, 256])
@pytest.mark.parametrize("output", ["full", "last_only"])
@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_plain_version_is_nn_lstm(direction, output, i, t):
    """The forward direction alone (layer 2's launch), or with the backward
    direction beside it (layer 1's: forward half, then backward half), in
    float64 within 1e-12 of ``nn.LSTM``: the same recurrence, with the input
    gates' two biases summed before the product's sum is added."""
    lstm, x = _lstm(i), _x(t, i)
    sfx = ("",) if direction == "forward" else ("", "_reverse")
    with torch.no_grad():
        full = lstm(x)[0]
        xg = k4.input_gates(x, lstm, sfx)
        got = k4.lstm_scan_reference(xg, tuple(getattr(lstm, f"weight_hh_l0{s}") for s in sfx),
                                     last_only=output == "last_only")
    ref = full if direction == "backward" else full[..., :H]
    if output == "last_only":  # each direction's last step: position T-1 forward, 0 backward
        ref = ref[:, -1] if direction == "forward" else torch.cat([full[:, -1, :H], full[:, 0, H:]], -1)
    assert got.shape == ref.shape
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-12)


@pytest.mark.parametrize("t", [1, 63])
def test_bilstm_k4_route_is_the_module_output(t):
    """``BiLSTM``'s K4 route (``_scan``; on the CPU the plain version) reads
    the module's tensors as cuDNN does: the full output and ``last_only``'s
    position T-1 agree with ``nn.LSTM`` within 1e-12 (float64)."""
    bi = BiLSTM(19, H).double()
    x = _x(t, 19)
    with torch.no_grad():
        full = bi.lstm(x)[0]
        torch.testing.assert_close(bi._scan(x), full, rtol=0, atol=1e-12)
        torch.testing.assert_close(bi._scan(x, last_only=True), full[:, -1, :H], rtol=0, atol=1e-12)


def _variant(case: str):
    """(x, lstm, lengths, grad mode) differing from an input the kernel takes
    by ``case`` and by lying on the CPU."""
    lstm = torch.nn.LSTM(19, 32 if case == "hidden32" else H, batch_first=True, bidirectional=True)
    dtype = {"float64": torch.float64, "bfloat16": torch.bfloat16}.get(case, torch.float32)
    lstm = lstm.to(dtype)
    x = _x(4, 19, dtype=dtype)
    if case == "unbatched":
        x = x[0]
    if case == "grad_x":
        x.requires_grad_(True)
    if case != "grad_param":
        lstm.requires_grad_(False)
    lengths = torch.tensor([4, 2, 1]) if case == "lengths" else None
    return x, lstm, lengths, case.startswith("grad")


@pytest.mark.parametrize(
    "case, reason",
    [("cpu", None), ("grad_x", "grad"), ("grad_param", "grad"), ("lengths", "lengths"),
     ("hidden32", "hidden"), ("float64", "dtype"), ("bfloat16", "dtype"), ("unbatched", "shape")],
)
def test_route_refuses(case, reason):
    x, lstm, lengths, grad = _variant(case)
    with torch.set_grad_enabled(grad):
        assert k4.refusals(x, lstm, lengths) == ["device"] + ([reason] if reason else [])
        assert not k4.takes(x, lstm, lengths)


def test_route_needs_no_grad_under_inference_mode():
    """Module parameters require grad; under ``inference_mode`` (or
    ``no_grad``) no backward can be asked, so only the device remains."""
    lstm = torch.nn.LSTM(19, H, batch_first=True, bidirectional=True)
    x = _x(4, 19, dtype=torch.float32)
    assert "grad" in k4.refusals(x, lstm)
    with torch.inference_mode():
        assert k4.refusals(x, lstm) == ["device"]
    with torch.no_grad():
        assert k4.refusals(x.requires_grad_(True), lstm) == ["device"]


def test_cpu_path_launches_nothing():
    ops.reset_launch_counts()
    before = ops.launch_counts()
    model = BiLSTMClassifier(hidden=H).eval()
    x = _x(7, 19, dtype=torch.float32)
    with torch.inference_mode():
        model(x)
        k4.lstm_scan(k4.input_gates(x, model.bilstm1.lstm, ("",)), (model.bilstm1.lstm.weight_hh_l0,))
    assert ops.launch_counts() == before


def test_input_gates_and_weights_are_checked():
    w = torch.zeros(4 * H, H)
    with pytest.raises(ValueError, match="input gates"):
        k4.lstm_scan(torch.zeros(2, 3, 4 * H + 1), (w,))
    with pytest.raises(ValueError, match="input gates"):
        k4.lstm_scan(torch.zeros(2, 0, 4 * H), (w,))
    with pytest.raises(ValueError, match="W_hh"):
        k4.lstm_scan(torch.zeros(2, 3, 8 * H), (w, torch.zeros(4 * H, H + 1)))
    with pytest.raises(ValueError, match="directions"):
        k4.lstm_scan(torch.zeros(2, 3, 12 * H), (w, w, w))


class FakeEntry:
    """The C entry point: records its arguments and returns 0."""

    def __init__(self):
        self.calls = []

    def __call__(self, *args) -> int:
        self.calls.append(args)
        return 0


@pytest.fixture
def fake_card(monkeypatch):
    """K4's launch without a card: the tensors stay on the CPU, the wrapper
    takes them for card tensors, and the entry point is ``FakeEntry``."""
    entry = FakeEntry()
    monkeypatch.setattr(k4, "on_card", lambda x, kernel: True)
    monkeypatch.setattr(k4._build, "entry_point", lambda *args: entry)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: SimpleNamespace(cuda_stream=STREAM))
    ops.reset_launch_counts()
    yield entry
    ops.reset_launch_counts()


@pytest.mark.parametrize("n_dirs, last_only", [(2, False), (1, True)], ids=["layer1", "layer2"])
def test_launch_hands_the_kernel_its_strides_and_counts_once(fake_card, n_dirs, last_only):
    B, T = 3, 5
    xg = torch.zeros(B, T, n_dirs * 4 * H)
    ws = tuple(torch.zeros(4 * H, H) for _ in range(n_dirs))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = k4.lstm_scan(xg, ws, last_only=last_only)
    assert out.shape == ((B, n_dirs * H) if last_only else (B, T, n_dirs * H))
    assert fake_card.calls == [(
        xg.data_ptr(), T * n_dirs * 4 * H, n_dirs * 4 * H, ws[0].data_ptr(), ws[-1].data_ptr(),
        out.data_ptr(), out.stride(0), 0 if last_only else n_dirs * H, B, T, n_dirs, int(last_only), STREAM,
    )]
    assert ops.launch_counts() == {**dict.fromkeys(ops.LAUNCH_COUNTERS, 0), "lstm_scan": 1}
    names = [e.name() for e in prof.profiler.kineto_results.events() if e.is_user_annotation()]
    assert names.count("lstm.scan") == 1


def test_launch_refuses_weights_that_need_grad(fake_card):
    w = torch.zeros(4 * H, H, requires_grad=True)
    with pytest.raises(RuntimeError, match=r"lstm_scan: .*no backward"):
        k4.lstm_scan(torch.zeros(2, 3, 4 * H), (w,))
    assert fake_card.calls == [] and ops.launch_counts()["lstm_scan"] == 0
