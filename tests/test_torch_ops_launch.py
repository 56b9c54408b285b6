"""The kernels' one launch path and launch ledger (``ops/__init__.py``), on the CPU.

No kernel runs here: ``launch`` is driven with a fake C entry point, and the
CUDA device context and stream it enters are stood in for, so the order of
its steps shows without a card.
"""

import contextlib
from types import SimpleNamespace

import pytest
import torch

from audioanalysisdetector_tpu_torch import ops

STREAM = 0x5EED


class FakeEntry:
    """A C entry point that records its calls and returns ``rc``."""

    def __init__(self, rc: int = 0):
        self.rc, self.calls = rc, []

    def __call__(self, *args) -> int:
        self.calls.append(args)
        return self.rc


@pytest.fixture
def fake_card(monkeypatch):
    """``launch``'s device context and stream, without a card."""
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: SimpleNamespace(cuda_stream=STREAM))
    ops.reset_launch_counts()
    yield
    ops.reset_launch_counts()


def _zeros() -> dict[str, int]:
    return dict.fromkeys(ops.LAUNCH_COUNTERS, 0)


def test_the_ledger_keeps_every_counter_in_order():
    assert ops.LAUNCH_COUNTERS == (
        "wave_mel", "fused_mel_from_frames", "ct_mel", "ct_mel.reflect", "ct_mel.db", "lstm_scan", "lstm_scan.h32",
        "cqcc", "gmm_llr",
    )
    assert tuple(ops.launch_counts()) == ops.LAUNCH_COUNTERS
    counts = ops.launch_counts()
    counts["ct_mel"] += 1  # a copy: the ledger is unchanged
    assert ops.launch_counts()["ct_mel"] == counts["ct_mel"] - 1


def test_reset_launch_counts_zeroes_every_name(fake_card):
    entry = FakeEntry()
    for name in ops.LAUNCH_COUNTERS:
        ops.launch(entry, torch.zeros(2), name, rows=2)
    assert set(ops.launch_counts().values()) == {1}
    ops.reset_launch_counts()
    assert ops.launch_counts() == _zeros()


def test_launch_refuses_grad_before_the_entry_point_and_the_count(fake_card):
    entry = FakeEntry()
    x = torch.zeros(2, 3, requires_grad=True)
    with pytest.raises(RuntimeError, match=r"ct_mel: .*no backward.*torch\.no_grad"):
        ops.launch(entry, x, "ct_mel", 1, 2, rows=2, counters=("ct_mel.reflect",))
    assert entry.calls == [] and ops.launch_counts() == _zeros()
    with torch.no_grad():
        ops.launch(entry, x, "ct_mel", 1, 2, rows=2, counters=("ct_mel.reflect",))
    assert entry.calls == [(1, 2, STREAM)]


def test_launch_appends_the_stream_and_counts_each_named_counter_once(fake_card):
    entry = FakeEntry()
    ops.launch(entry, torch.zeros(3), "ct_mel", 7, 8.5, rows=3, counters=("ct_mel.reflect",))
    ops.launch(entry, torch.zeros(3), "wave_mel", 9, rows=3)
    ops.launch(entry, torch.zeros(3), "ct_mel", 10, rows=3, counters=("ct_mel.reflect", "ct_mel.db"))
    assert entry.calls == [(7, 8.5, STREAM), (9, STREAM), (10, STREAM)]
    assert ops.launch_counts() == {**_zeros(), "ct_mel": 2, "ct_mel.reflect": 2, "ct_mel.db": 1, "wave_mel": 1}


@pytest.mark.parametrize("kernel", ["lstm_scan", "lstm_scan.h32", "cqcc", "gmm_llr"])
def test_each_kernel_counts_on_its_own_counter(fake_card, kernel):
    entry = FakeEntry()
    ops.launch(entry, torch.zeros(4), kernel, 5, rows=4)
    ops.launch(entry, torch.zeros(4), kernel, 6, rows=4)
    assert entry.calls == [(5, STREAM), (6, STREAM)]
    assert ops.launch_counts() == {**_zeros(), kernel: 2}


def test_a_failed_launch_raises_and_is_not_counted(fake_card):
    with pytest.raises(RuntimeError, match="fused_mel_from_frames kernel launch failed with CUDA error 700"):
        ops.launch(FakeEntry(rc=700), torch.zeros(2), "fused_mel_from_frames", rows=2)
    assert ops.launch_counts() == _zeros()


def test_rows_past_the_int_index_raise_before_the_entry_point(fake_card):
    entry = FakeEntry()
    with pytest.raises(ValueError, match="overflow the kernel's int row index"):
        ops.launch(entry, torch.zeros(2), "wave_mel", rows=2**31)
    ops.launch(entry, torch.zeros(2), "wave_mel", rows=2**31 - 1)
    assert len(entry.calls) == 1 and ops.launch_counts()["wave_mel"] == 1


def test_on_card_takes_cpu_and_refuses_other_devices():
    assert ops.on_card(torch.zeros(1), "wave_mel") is False
    with pytest.raises(NotImplementedError, match="wave_mel has no path for meta"):
        ops.on_card(torch.zeros(1, device="meta"), "wave_mel")
