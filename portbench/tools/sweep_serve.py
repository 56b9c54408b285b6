#!/usr/bin/env python3
"""Find the highest request rate a serving cell's service sustains.

    python3 portbench/tools/sweep_serve.py --workload <cell> --rates 100,200,300 [--seconds 10] [--seed 5]

Builds the service once and offers the cell's traffic at each rate in turn
(``drivers/serve.py::offer``). A rate is sustained when at least 99% of
the requests due in the window were answered and the latency of the last
quarter's requests is no more than twice that of the first quarter's plus
10 ms (the backlog did not grow). One JSON line per rate. The cell's
traffic file then fixes a rate of about four fifths of the highest
sustained one. Runs on the card; not part of the benchmark's runs.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--seed", type=int, default=5)
    p.add_argument("--threads", type=int, default=0, help="client threads (default: the traffic file's)")
    args = p.parse_args()
    sys.path.insert(0, str(ROOT))
    from portbench.harness import audio
    from portbench.harness.cells import load_cell
    from portbench.harness.openloop import latencies_ms, percentile, schedule

    cell = load_cell(args.workload)
    if args.threads:
        cell.traffic["client_threads"] = args.threads
    driver = cell.driver()
    device = "cuda"
    weights = cell.system().make_weights(cell.config, audio.seed_generator(args.seed, device), device,
                                         cell.traffic["audio"])
    with driver.serving(cell, weights, device, timed=False) as (batcher, port, n_samples, tmp, _):
        for rate in (float(r) for r in args.rates.split(",")):
            cell.traffic["rate_req_per_s"] = rate
            _, results, delta, _ = driver.offer(cell, batcher, port, args.seed, args.seconds, n_samples,
                                                driver.traffic_file(cell.traffic, tmp), False, device,
                                                time.perf_counter())
            reqs = schedule(cell.traffic, args.seed, args.seconds)
            done = {i: (r[0] if r[1] == 200 else None) for i, r in results.items()}
            lat = latencies_ms(reqs, done)
            q = len(reqs) // 4
            first = statistics.median(lat[:q])
            last = statistics.median(lat[-q:])
            answered = sum(1 for r in reqs if done.get(r.index) is not None) / len(reqs)
            utt = sum(len(r.rows) for r in reqs) / args.seconds
            print(json.dumps({"rate_req_per_s": rate, "offered_utt_per_s": utt, "answered": answered,
                              "p50_ms": percentile(lat, 50), "p95_ms": percentile(lat, 95),
                              "p99_ms": percentile(lat, 99), "first_quarter_ms": first, "last_quarter_ms": last,
                              "sustained": answered >= 0.99 and last <= 2 * first + 10.0,
                              "rows_per_dispatch": delta["utterances"] / max(delta["batches"], 1),
                              "rejected": delta["rejected"],
                              "p95_ms_by_second": [round(percentile([x for r, x in zip(reqs, lat)
                                                                     if int(r.due_s) == s_], 95), 1)
                                                   for s_ in range(int(args.seconds))]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
