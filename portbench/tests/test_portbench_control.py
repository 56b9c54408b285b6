"""The control on the card: the reference put in the program's place one
precision below the configuration's (float32 with TF32 on, against IEEE
float32) comes out not correct, at a size a test run holds. The readings
at the cells' own sizes are in ``PERF.md`` (``tools/calibrate.py``)."""

from __future__ import annotations

import pytest

from portbench.tests.conftest import tiny

SIZES = {
    "mel-parity.offline": {"batch": 1024, "pool_batches": 1},
    "cqcc-fused.offline": {"batch": 1024, "pool_batches": 1},
    "mel-parity.serve": {"pool_utterances": 1024},
    "mel-parity.train": {"utterances": 1000, "batch": 200},
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SIZES))
@pytest.mark.parametrize("seed", [101, 2**31 + 102, 103])
def test_tf32_control_is_not_correct(name, seed, card):
    cell = tiny(name, **SIZES[name])
    cell.config.update(calibration_rows=64, scaler_rows=256)
    readings = cell.driver().control(cell, seed, card)
    limits = cell.config["limits"]
    assert any(value > limits[key] for key, value in readings.items()), readings
