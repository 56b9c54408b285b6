"""Cells from ``BENCHMARK.json``, and every file of one found by its name.

A cell names a configuration (``configs/<config>.json``) and a traffic mix
(``traffic/<traffic>.json``). The configuration names its system
(``systems/<system>.py``: the port's side) and its plain reference
(``reference/<reference>.py``); the traffic names its driver
(``drivers/<kind>.py``). A per-layer metric is ``metrics/<name>.py``.
Adding a cell adds files and a ``workloads`` entry; no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_module(path: Path, name: str) -> ModuleType:
    """Import the Python file ``path`` as module ``name`` (metric files carry
    dots in their names, so they are loaded by path, not by import)."""
    if name in sys.modules:
        return sys.modules[name]
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    try:
        spec.loader.exec_module(module)
    except BaseException:
        del sys.modules[name]
        raise
    return module


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list[dict]  # the metrics this cell reports with --trace 0
    per_layer: list[dict]  # the metrics this cell reports with --trace 1

    def system(self) -> ModuleType:
        return load_module(BENCH_DIR / "systems" / f"{self.config['system']}.py",
                           f"portbench_system_{self.config['system']}")

    def reference(self) -> ModuleType:
        return load_module(BENCH_DIR / "reference" / f"{self.config['reference']}.py",
                           f"portbench_reference_{self.config['reference']}")

    def driver(self) -> ModuleType:
        return load_module(BENCH_DIR / "drivers" / f"{self.traffic['driver']}.py",
                           f"portbench_driver_{self.traffic['driver']}")


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str) -> Cell:
    """The cell ``name`` of the checkout's ``BENCHMARK.json``, with its files read."""
    bench = read_json(ROOT / "BENCHMARK.json")
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if len(entries) != 1:
        raise KeyError(f"no single workload {name!r} in BENCHMARK.json")
    w = entries[0]
    config = read_json(BENCH_DIR / "configs" / f"{w['config']}.json")
    traffic = read_json(BENCH_DIR / "traffic" / f"{w['traffic']}.json")
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in e2e_names)]
    return Cell(name=name, config=config, traffic=traffic, chips=int(w["chips"]),
                end_to_end=e2e, per_layer=per_layer)


def unlisted_cell(name: str, config: str, traffic: str) -> Cell:
    """A cell of ``configs/<config>.json`` under ``traffic/<traffic>.json``
    that ``BENCHMARK.json`` does not list (the calibration and fault tools
    read such a cell before an entry is added): no metrics to report."""
    return Cell(name=name, config=read_json(BENCH_DIR / "configs" / f"{config}.json"),
                traffic=read_json(BENCH_DIR / "traffic" / f"{traffic}.json"), chips=1,
                end_to_end=[], per_layer=[])


def metric_reader(name: str) -> ModuleType:
    return load_module(BENCH_DIR / "metrics" / f"{name}.py", f"portbench_metric_{name.replace('.', '_')}")
