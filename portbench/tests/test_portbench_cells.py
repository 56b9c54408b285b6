"""Cells are found by name from ``BENCHMARK.json``, and the file keeps the
contract's shape."""

from __future__ import annotations

import json
import re

import pytest

from portbench.harness.cells import BENCH_DIR, ROOT, load_cell, metric_reader

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"] and BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_found_by_name(name):
    cell = load_cell(name)
    assert cell.chips == 1
    for module in (cell.system(), cell.reference(), cell.driver()):
        assert module is not None
    assert cell.traffic["driver"] in ("offline", "serve", "train")
    assert [m["name"] for m in cell.end_to_end][0] == "setup_s" and len(cell.end_to_end) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert hasattr(metric_reader(m["name"]), "read")
        assert m["moves"] in {e["name"] for e in cell.end_to_end}


def test_names_units_bounds():
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in BENCH[section]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert [m["name"] for m in BENCH["end_to_end"]] == ["setup_s", "score_utt_per_s"]
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_configs_match_their_files():
    for c in BENCH["configs"]:
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["name"] == c["name"] and data["reduced"] == c["reduced"] == []
        assert c["file"].startswith("portbench/configs/")
        assert (BENCH_DIR / "reference" / f"{data['reference']}.py").is_file()
        assert (BENCH_DIR / "systems" / f"{data['system']}.py").is_file()


@pytest.mark.parametrize("name", ["mel-parity.serve", "mel-parity.train"])
def test_pending_cells_have_their_files(name):
    from portbench.tests.conftest import tiny

    cell = tiny(name)
    assert cell.driver() and cell.system() and cell.reference()
    assert name not in CELLS


def test_unknown_cell():
    with pytest.raises(KeyError):
        load_cell("no-such.cell")
