"""Serving: the HTTP service built as ``cli serve`` builds it, in this
process, under an open loop of requests from client processes of their own.

The system's ``serve_scorer`` gives the scorer ``build_mel_scorer`` makes
from a checkpoint (the benchmark's weights, saved in ``TMPDIR``); it goes
behind ``BatchingScorer`` (``max_batch``, ``max_wait_ms``, the default
bucket ladder, the adaptive window) and ``ScoreServer`` on a free local
port. Every bucket is warmed before the window.

Traffic parameters: ``rate_req_per_s``, ``raw_share``, ``raw_rows``,
``pool_utterances``, ``base_seed``, ``clients``, ``client_threads``, ``max_batch``,
``max_wait_ms``, ``audio`` (``harness/openloop.py``,
``drivers/serve_client.py``). End-to-end: ``serve_p95_ms``, the 95th
percentile over every request due in the window, each timed from when it
was due, a failed one as infinitely late. ``correct``: every request
answered, every served score against the float64 reference of the rows
the request carried.
"""

from __future__ import annotations

import contextlib
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from portbench.harness import audio
from portbench.harness.openloop import latencies_ms, percentile, schedule
from portbench.harness.result import Outcome
from portbench.harness.trace import Window, prepare

CLIENT = Path(__file__).resolve().parent / "serve_client.py"


class TimedScorer:
    """The scorer handed to ``BatchingScorer``, with the host time of each
    call kept (a traced run's ``serve.dispatch_ms``). It keeps the
    scorer's ``platform`` and ``row_multiple``."""

    def __init__(self, scorer):
        self._scorer = scorer
        self.platform = getattr(scorer, "platform", "unknown")
        self.row_multiple = getattr(scorer, "row_multiple", 1)
        self.seconds: list[float] = []

    def __call__(self, wav):
        t0 = time.perf_counter()
        out = self._scorer(wav)
        self.seconds.append(time.perf_counter() - t0)
        return out


def start_clients(cell, port: int, seed: int, seconds: float, n_samples: int, traffic_path: str) -> list:
    k = int(cell.traffic["clients"])
    procs = []
    for i in range(k):
        procs.append(subprocess.Popen(
            [sys.executable, str(CLIENT), "--port", str(port), "--seed", str(seed), "--seconds", str(seconds),
             "--traffic", traffic_path, "--index", str(i), "--of", str(k), "--sr", str(cell.config["sr"]),
             "--n-samples", str(n_samples), "--threads", str(cell.traffic["client_threads"])],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True))
    for proc in procs:
        if proc.stdout.readline().strip() != "ready":
            raise RuntimeError("a serving client did not start")
    return procs


def stop(procs: list) -> None:
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
        proc.wait(timeout=30)


def collect(procs: list, seconds: float) -> dict[int, list]:
    """Every client's results, by request index."""
    out = {}
    for proc in procs:
        text, _ = proc.communicate(timeout=seconds + 120)
        for index, done, status, scores in json.loads(text.strip().splitlines()[-1])["results"]:
            out[index] = [done, status, scores]
    return out


def offer(cell, batcher, port: int, seed: int, seconds: float, n_samples: int, traffic_path: str,
          trace: bool, device: str, t_start: float):
    """One open-loop window against a running server: (setup_s, results by
    request index, stats delta, the window's trace summary)."""
    prepare(trace, device)
    procs = start_clients(cell, port, seed, seconds, n_samples, traffic_path)
    try:
        before = batcher.stats.snapshot()
        t0 = time.monotonic() + 0.2
        setup_s = time.perf_counter() - t_start + 0.2
        for proc in procs:
            proc.stdin.write(f"go {t0!r}\n")
            proc.stdin.flush()
        with Window(trace, device) as window:
            results = collect(procs, seconds)
        after = batcher.stats.snapshot()
    finally:
        stop(procs)
    delta = {k: after[k] - before[k] for k in ("requests", "utterances", "batches", "rejected", "errors")}
    return setup_s, results, delta, window.summary


@contextlib.contextmanager
def serving(cell, weights: dict, device: str, timed: bool):
    """The service over ``weights``, warmed and listening on a free local
    port: yields (batcher, port, n_samples, scratch directory, the timed
    scorer or None). Closed, and its directory removed, on the way out."""
    from audioanalysisdetector_tpu_torch.serve.server import BatchingScorer, ScoreServer, default_bucket_ladder

    cfg, tr = cell.config, cell.traffic
    tmp = tempfile.mkdtemp(prefix="portbench-serve-")
    server = None
    try:
        scorer, n_samples = cell.system().serve_scorer(cfg, weights, tmp, device)
        wrapped = TimedScorer(scorer) if timed else None
        max_batch = int(tr["max_batch"])
        batcher = BatchingScorer(wrapped or scorer, n_samples=n_samples, max_batch=max_batch,
                                 max_wait_ms=float(tr["max_wait_ms"]),
                                 bucket_sizes=default_bucket_ladder(max_batch), adaptive=True)
        batcher.warm_up()
        server = ScoreServer(batcher, sr=cfg["sr"], host="127.0.0.1", port=0)
        server.start_background()
        if wrapped is not None:
            wrapped.seconds.clear()
        yield batcher, server.port, n_samples, tmp, wrapped
    finally:
        if server is not None:
            server.close()
        shutil.rmtree(tmp, ignore_errors=True)


def traffic_file(tr: dict, directory: str) -> str:
    """The traffic as the clients read it (the cell's, as loaded)."""
    path = Path(directory) / "traffic.json"
    path.write_text(json.dumps(tr))
    return str(path)


def pool_rows(cell, seed: int, n_samples: int, device: str) -> torch.Tensor:
    """The clients' utterance pool as the service decodes it: ``q / 32768``."""
    tr = cell.traffic
    pool = audio.waves_np(int(tr["pool_utterances"]), n_samples, cell.config["sr"], seed, tr["audio"])
    return torch.from_numpy(pool.astype(np.float32) / 32768.0).to(device)


def control(cell, seed: int, device: str) -> dict[str, float]:
    """``score_gap`` read off the control (the reference at float32 with
    TF32 on) over the utterance pool of ``seed``."""
    from portbench.reference.common import precision

    cfg, ref = cell.config, cell.reference()
    weights = cell.system().make_weights(cfg, audio.seed_generator(seed, device), device, cell.traffic["audio"])
    rows = pool_rows(cell, seed, cfg["n_samples"], device)
    exact, compared = ref.evaluate(cfg, weights, rows, aux={})
    with precision(tf32=True):
        low = ref.scores(cfg, weights, rows, aux={}, dtype=torch.float32)
    return {"score_gap": float((low.double() - exact).abs()[compared].max())}


def run(cell, *, seed: int, seconds: float, trace: bool, device: str, t_start: float) -> Outcome:
    cfg, tr = cell.config, cell.traffic
    weights = cell.system().make_weights(cfg, audio.seed_generator(seed, device), device, tr["audio"])
    with serving(cell, weights, device, timed=trace) as (batcher, port, n_samples, tmp, timed):
        setup_s, results, delta, summary = offer(cell, batcher, port, seed, seconds, n_samples,
                                                 traffic_file(tr, tmp), trace, device, t_start)

    requests = schedule(tr, seed, seconds)
    done = {i: (r[0] if r[1] == 200 else None) for i, r in results.items()}
    lat = latencies_ms(requests, done)
    out = Outcome(setup_s=setup_s, attempted=len(requests))
    out.failed = sum(1 for r in requests if done.get(r.index) is None)
    out.end_to_end["serve_p95_ms"] = percentile(lat, 95.0)
    out.note_memory(device)
    if trace:
        out.trace = summary
        out.context.update(dispatches=delta["batches"], dispatched_utterances=delta["utterances"],
                           dispatch_s=list(timed.seconds))
    out.context["lateness"] = {"p50_ms": percentile(lat, 50.0), "p99_ms": percentile(lat, 99.0),
                               "stats": delta}

    rows = pool_rows(cell, seed, n_samples, device)
    exact, compared = (t.cpu().numpy() for t in cell.reference().evaluate(cfg, weights, rows, aux={}))
    worst, left_out = 0.0, 0
    for r in requests:
        got = results.get(r.index, [None, 0, None])[2]
        if got is None:
            continue
        idx = np.asarray(r.rows)
        gap = np.abs(np.asarray(got, dtype=np.float64) - exact[idx])[compared[idx]]
        left_out += int((~compared[idx]).sum())
        if gap.size:
            worst = max(worst, float(gap.max()) if np.isfinite(gap).all() else float("inf"))
    out.context["left_out"] = f"{left_out} answers" if left_out else None
    out.check("score_gap", worst, cfg["limits"]["score_gap"])
    out.check("unanswered", out.failed, 0)
    return out
