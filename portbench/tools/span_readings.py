#!/usr/bin/env python3
"""The program's spans read in an offline cell's traced window.

    python3 portbench/tools/span_readings.py --workload mel-parity.offline --seeds 1,2 [--seconds 10]
        [--batch 8192] [--device cuda]

For each seed: the cell's offline window as ``drivers/offline.py`` runs it
(inputs and weights from the seed, the scorer warmed, calls back to back,
one synchronisation), under ``harness/trace.py::Window``; then
``harness/spans.py`` on the window's events. One JSON line a seed: the
traced rate, the busy time a call, the device ms a call under each span
(``score.frontend``, ``score.model``, ``mel.pad``, ``fused.gmm``), the
launches a call under ``score.call``, the unattributed share of the busy
time, the idle gaps named by span path beside ``summarize``'s names, the
time from the window's start to the first device operation and from the
last one to the window's end, and the after-window CUDA-event times the
offline driver reports
(``frontend_ms``, ``model_ms``). A program without spans reads None for
every span. All lines go to
``chiprun_out/span_readings-<cell>.jsonl`` too. Runs on the card; not part
of the benchmark's runs.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SPANS = ("score.call", "score.frontend", "score.model", "mel.pad", "fused.gmm")


def window(cell, seed: int, seconds: float, device: str):
    """(events, calls, traced rate, outside frontend ms, outside model ms)."""
    from portbench.drivers.offline import inputs
    from portbench.harness.result import device_ms, sync
    from portbench.harness.spans import records
    from portbench.harness.trace import Window

    batch = int(cell.traffic["batch"])
    system = cell.system()
    weights, aux, pool = inputs(cell, system, seed, device)
    program = system.build(cell.config, weights, aux, device)
    for _ in range(2):
        program.score(pool[0])
    sync(device)
    calls = 0
    with Window(True, device) as w:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            program.score(pool[calls % len(pool)])
            calls += 1
        sync(device)
        elapsed = time.perf_counter() - t0
    events = records(w._prof)
    feats = program.frontend(pool[0])
    outside = (device_ms(lambda: program.frontend(pool[0]), device), device_ms(lambda: program.model(feats), device))
    return events, calls, calls * batch / elapsed, *outside


def readings(events, calls: int) -> dict:
    from portbench.harness.spans import attribute, per_call, summarize_spans, window_range
    from portbench.harness.trace import summarize

    times = attribute(events)
    named = summarize_spans(events)
    plain = summarize([(e.name, e.on_device, e.start, e.end) for e in events])
    lo, hi = window_range(events)
    device = [e for e in events if e.on_device and e.end > lo and e.start < hi]
    return {
        "lead_in_ms": 1e3 * (min(e.start for e in device) - lo) if device else None,
        "tail_ms": 1e3 * (hi - max(e.end for e in device)) if device else None,
        "calls": calls, "span_calls": times.calls.get("score.call", 0),
        "busy_ms_per_call": 1e3 * times.busy_s / calls, "idle_share": plain.idle_share,
        "unattributed_share": times.unattributed_s / times.busy_s if times.busy_s else None,
        "device_ms": {name: per_call(times, name) for name in SPANS},
        "launches_per_call": per_call(times, "score.call", launches=True),
        "idle_gaps": named.idle_gaps, "idle_gaps_summarize": plain.idle_gaps,
    }


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--batch", type=int, help="utterances a call, in place of the cell's")
    p.add_argument("--device", default="cuda")
    args = p.parse_args()
    sys.path.insert(0, str(ROOT))
    from portbench.harness.cells import load_cell
    from portbench.yardstick.peaks import power_limit

    cell = load_cell(args.workload)
    if args.batch:
        cell.traffic["batch"] = args.batch
    out_path = ROOT / "chiprun_out" / f"span_readings-{args.workload}.jsonl"
    out_path.parent.mkdir(exist_ok=True)
    with open(out_path, "a") as f:
        for seed in (int(s) for s in args.seeds.split(",")):
            events, calls, rate, front_ms, model_ms = window(cell, seed, args.seconds, args.device)
            row = {"workload": args.workload, "seed": seed, "card": power_limit() if args.device != "cpu" else "cpu", "batch": cell.traffic["batch"],
                   "traced_utt_per_s": rate, **readings(events, calls),
                   "frontend_ms": front_ms, "model_ms": model_ms}
            text = json.dumps(row)
            print(text, flush=True)
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
