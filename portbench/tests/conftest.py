"""Tests of the benchmark itself: ``python -m pytest portbench/tests``.

They run on the CPU at tiny sizes; a test marked ``cuda`` needs a card and
decides so in its fixture, skipping here with the reason."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    """The card, or a skip with the reason."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: this check runs on the card only")
    return "cuda"


# cells whose harness files are in place but which BENCHMARK.json does not
# list yet (PERF.md §7): configuration, traffic and end-to-end metrics, as a
# later entry would give them
PENDING = {
    "mel-parity.serve": ("mel-parity", "serve-steady", "serve_p95_ms", "ms"),
    "mel-parity.train": ("mel-parity", "train-asvspoof-la", "train_utt_per_s", "utt/s"),
}


def tiny(name: str, **traffic):
    """The cell ``name`` cut to CPU size: small batches and pools, few
    calibration and scaler rows."""
    from portbench.harness.cells import load_cell, unlisted_cell

    if name in PENDING:
        config, traffic_name, metric, unit = PENDING[name]
        cell = unlisted_cell(name, config, traffic_name)
        cell.end_to_end = [{"name": "setup_s", "unit": "s"}, {"name": metric, "unit": unit}]
    else:
        cell = load_cell(name)
    if cell.traffic["driver"] == "offline":
        cell.traffic.update(batch=4, pool_batches=2)
    else:
        cell.traffic.update(rate_req_per_s=20.0, pool_utterances=16, max_batch=8)
    cell.traffic.update(traffic)
    cell.config.update(calibration_rows=8, scaler_rows=8)
    return cell
