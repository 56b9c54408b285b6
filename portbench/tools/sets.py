#!/usr/bin/env python3
"""Repeated runs of one cell, each a fresh process, and their spreads.

    python3 portbench/tools/sets.py --workload <cell> --seeds 1,2,3,4,5,6 [--sets 2] [--seconds 10] [--trace-seeds 7,8,9]

Runs ``portbench/run.py`` once per seed, ``--sets`` times over the same
seeds, then once per trace seed with ``--trace 1``. For each metric and
set it prints the spread: the distance between the first and third
quartiles (``statistics.quantiles(values, n=4)``) as a share of the
median. Every result line, and the summary, go to
``chiprun_out/sets-<cell>.jsonl``. A bound is about five times the widest
spread of a metric (``PERF.md`` §2). Not part of the benchmark's runs.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def spread(values: list[float]) -> float:
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def one(workload: str, seed: int, seconds: float, trace: int) -> dict:
    proc = subprocess.run([sys.executable, str(ROOT / "portbench" / "run.py"), "--workload", workload,
                           "--seed", str(seed), "--seconds", str(seconds), "--trace", str(trace)],
                          capture_output=True, text=True, cwd=ROOT, timeout=1200)
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not lines:
        return {"seed": seed, "trace": trace, "rc": proc.returncode, "stderr": proc.stderr[-2000:]}
    return {"seed": seed, "trace": trace, "rc": 0, **json.loads(lines[-1])}


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--sets", type=int, default=2)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--trace-seeds", default="")
    args = p.parse_args()
    seeds = [int(s) for s in args.seeds.split(",")]
    out_path = ROOT / "chiprun_out" / f"sets-{args.workload}.jsonl"
    out_path.parent.mkdir(exist_ok=True)
    sets: list[list[dict]] = []
    with open(out_path, "a") as f:
        def keep(row: dict) -> dict:
            f.write(json.dumps(row) + "\n")
            f.flush()
            short = {k: row.get(k) for k in ("seed", "trace", "rc", "correct", "attempted", "failed")}
            short["metrics"] = {k: v["value"] for k, v in row.get("metrics", {}).items()}
            short["checks"] = {k: v["value"] for k, v in row.get("checks", {}).items()}
            if row.get("rc"):
                short["stderr"] = row["stderr"][-600:]
            print(json.dumps(short), flush=True)
            return row

        for i in range(args.sets):
            sets.append([keep({**one(args.workload, s, args.seconds, 0), "set": i}) for s in seeds])
        for s in (int(x) for x in args.trace_seeds.split(",") if x):
            keep(one(args.workload, s, args.seconds, 1))
        summary = {"workload": args.workload, "seconds": args.seconds, "spreads": {}, "medians": {}}
        for name in sets[0][0].get("metrics", {}):
            vals = [[r["metrics"][name]["value"] for r in runs if r.get("rc") == 0] for runs in sets]
            summary["spreads"][name] = [spread(v) for v in vals]
            summary["medians"][name] = [statistics.median(v) for v in vals]
            # the driver's tightness reading: each set's run farthest from its median left out
            trimmed = []
            for v in vals:
                med = statistics.median(v)
                far = max(range(len(v)), key=lambda j: abs(v[j] - med))
                trimmed.append(spread(v[:far] + v[far + 1:]))
            summary["spreads"][name + ".trimmed_mean"] = sum(trimmed) / len(trimmed)
        f.write(json.dumps(summary) + "\n")
        print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
