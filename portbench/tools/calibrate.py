#!/usr/bin/env python3
"""Readings that the limits of ``correct`` are set from, for one cell.

    python3 portbench/tools/calibrate.py --workload <cell> --seeds 1,2,3 [--seconds 2] [--control 3]

For each seed: one run of the cell with its window (``--seconds``), which
gives the number compared (``score_gap``) for the program: the lower
reading. For the first ``--control`` seeds: the control, the reference put
in the program's place at the next precision below the configuration's
(float32 with TF32 on, against float32 IEEE), on the same inputs: the upper
reading. One JSON line per reading, and all of them in
``chiprun_out/calibrate-<cell>.jsonl``. Runs on the card; not part of the
benchmark's runs.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--unlisted", nargs=2, metavar=("CONFIG", "TRAFFIC"),
                   help="a cell BENCHMARK.json does not list: its configuration and traffic")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--control", type=int, default=3)
    args = p.parse_args()
    sys.path.insert(0, str(ROOT))
    from portbench.harness.cells import load_cell, unlisted_cell
    from portbench.harness.report import report

    cell = unlisted_cell(args.workload, *args.unlisted) if args.unlisted else load_cell(args.workload)
    cell.config["limits"] = {k: float("inf") for k in cell.config["limits"]}
    device = "cuda"
    out_path = ROOT / "chiprun_out" / f"calibrate-{args.workload}.jsonl"
    out_path.parent.mkdir(exist_ok=True)
    seeds = [int(s) for s in args.seeds.split(",")]
    with open(out_path, "a") as f:
        for i, seed in enumerate(seeds):
            result, lines = report(cell, seed=seed, seconds=args.seconds, trace=False, device=device,
                                   t_start=time.perf_counter())
            print("\n".join(lines[1:-len(result["checks"])]), file=sys.stderr, flush=True)
            row = {"workload": args.workload, "seed": seed, "side": "program",
                   **{k: v["value"] for k, v in result["checks"].items()},
                   **{k: v["value"] for k, v in result["metrics"].items()}}
            if i < args.control:
                row_c = {"workload": args.workload, "seed": seed, "side": "control_tf32",
                         **cell.driver().control(cell, seed, device)}
                rows = [row, row_c]
            else:
                rows = [row]
            for r in rows:
                print(json.dumps(r), flush=True)
                f.write(json.dumps(r) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
