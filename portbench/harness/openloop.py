"""The open loop of a serving cell: a schedule of requests fixed by the
seed, latency timed from when each request was due, and the tail.

Every seed gets the same multiset of inter-arrival gaps and request sizes,
drawn from the traffic file's ``base_seed``; the run's seed only orders
them and picks which utterances each request carries. So two seeds offer
the same work in the same time, in another order.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class Request:
    index: int
    due_s: float  # offset from the window's start
    lane: str  # "wav" (one utterance, audio_b64 WAV on /v1/score) or "raw" (rows on /v1/score_raw)
    rows: tuple[int, ...]  # indices into the utterance pool


def schedule(traffic: dict, seed: int, seconds: float) -> list[Request]:
    """The requests due in ``[0, seconds)``: Poisson arrivals at
    ``rate_req_per_s``; a share ``raw_share`` of them carry
    ``raw_rows`` (inclusive range) utterances as raw rows, the rest one
    utterance as a WAV upload."""
    rate = float(traffic["rate_req_per_s"])
    n = max(1, int(round(rate * seconds)))
    base = np.random.default_rng(int(traffic["base_seed"]))
    gaps = base.exponential(1.0 / rate, n)
    gaps *= seconds / gaps.sum()  # every seed: n requests in the window
    lo, hi = traffic["raw_rows"]
    raw = base.random(n) < float(traffic["raw_share"])
    sizes = np.where(raw, base.integers(lo, hi + 1, n), 1)
    rng = np.random.default_rng(int(seed) % (1 << 63))
    gaps = gaps[rng.permutation(n)]
    order = rng.permutation(n)
    raw, sizes = raw[order], sizes[order]
    due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    pool = int(traffic["pool_utterances"])
    out = []
    for i in range(n):
        rows = tuple(int(r) for r in rng.integers(0, pool, int(sizes[i])))
        out.append(Request(i, float(due[i]), "raw" if raw[i] else "wav", rows))
    return out


def latencies_ms(requests: list[Request], done: dict[int, float | None]) -> list[float]:
    """Per request, milliseconds from due to answered (``done`` holds the
    answer's offset from the window's start, or None for a request that
    failed or never came): a failure counts as infinitely late."""
    out = []
    for r in requests:
        t = done.get(r.index)
        out.append(math.inf if t is None else (t - r.due_s) * 1e3)
    return out


def percentile(values: list[float], q: float) -> float:
    """Nearest-rank percentile: the smallest value with at least ``q``% of
    all values at or below it (inf when that value is a failure)."""
    if not values:
        raise ValueError("no values")
    s = sorted(values)
    k = max(1, math.ceil(q / 100.0 * len(s)))
    return s[k - 1]
