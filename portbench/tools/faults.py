#!/usr/bin/env python3
"""Faults planted in the port underneath a run, and the readings they give.

    python3 portbench/tools/faults.py --workload <cell> --fault <name> --seeds 1,2,3 [--seconds 2]

Each fault is a context manager that breaks the timed path the way a
faulty change would, and ``correct`` has to come out false under each
(``tests/test_portbench_correct.py`` holds that on the CPU). On the card
this prints the numbers compared under the fault, one JSON line a seed,
also kept in ``chiprun_out/faults-<cell>.jsonl``: a training cell's limits
are held against them. Not part of the benchmark's runs.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


@contextlib.contextmanager
def unchanged_state():
    """A training step that returns its state unchanged: no update."""
    from audioanalysisdetector_tpu_torch.train.state import TrainState

    saved = TrainState.apply_gradients
    TrainState.apply_gradients = lambda self: self
    try:
        yield
    finally:
        TrainState.apply_gradients = saved


@contextlib.contextmanager
def half_batch():
    """Half of each training batch left out, the loss the mean over the rest."""
    from audioanalysisdetector_tpu_torch.train import loop

    saved = loop.get_loss

    def get_loss(name):
        fn = saved(name)
        return lambda logits, y: fn(logits[: len(y) // 2], y[: len(y) // 2])

    loop.get_loss = get_loss
    try:
        yield
    finally:
        loop.get_loss = saved


@contextlib.contextmanager
def altered_token():
    """One input row of each training batch altered where the feed hands it
    over: its log-mel raised by 1 dB."""
    from audioanalysisdetector_tpu_torch.train import loop

    saved = loop.make_train_step

    def make_train_step(*a, **k):
        step = saved(*a, **k)

        def broken(state, x, y, generator):
            x = x.clone()
            x[0] += 1.0
            return step(state, x, y, generator)

        return broken

    loop.make_train_step = make_train_step
    try:
        yield
    finally:
        loop.make_train_step = saved


FAULTS = {"unchanged_state": unchanged_state, "half_batch": half_batch, "altered_token": altered_token}


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--fault", required=True, choices=sorted(FAULTS))
    p.add_argument("--seeds", required=True)
    p.add_argument("--unlisted", nargs=2, metavar=("CONFIG", "TRAFFIC"),
                   help="a cell BENCHMARK.json does not list: its configuration and traffic")
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args()
    sys.path.insert(0, str(ROOT))
    from portbench.harness.cells import load_cell, unlisted_cell
    from portbench.harness.report import report

    cell = unlisted_cell(args.workload, *args.unlisted) if args.unlisted else load_cell(args.workload)
    cell.config["limits"] = {k: float("inf") for k in cell.config["limits"]}
    out_path = ROOT / "chiprun_out" / f"faults-{args.workload}.jsonl"
    out_path.parent.mkdir(exist_ok=True)
    with open(out_path, "a") as f:
        for seed in (int(s) for s in args.seeds.split(",")):
            with FAULTS[args.fault]():
                result, _ = report(cell, seed=seed, seconds=args.seconds, trace=False, device="cuda",
                                   t_start=time.perf_counter())
            row = {"workload": args.workload, "seed": seed, "fault": args.fault,
                   **{k: v["value"] for k, v in result["checks"].items()}}
            print(json.dumps(row), flush=True)
            f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
