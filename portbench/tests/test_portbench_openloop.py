"""The open loop: a schedule fixed by the seed, latency from the due time,
and the tail over all requests with failures as infinitely late."""

from __future__ import annotations

import math
from collections import Counter

import pytest

from portbench.harness.openloop import latencies_ms, percentile, schedule

TRAFFIC = {"rate_req_per_s": 200.0, "raw_share": 0.2, "raw_rows": [2, 16], "pool_utterances": 64,
           "base_seed": 16}


def test_same_seed_same_schedule():
    assert schedule(TRAFFIC, 2**31 + 11, 5.0) == schedule(TRAFFIC, 2**31 + 11, 5.0)


def test_seeds_offer_the_same_work_in_another_order():
    a, b = schedule(TRAFFIC, 1, 5.0), schedule(TRAFFIC, 2, 5.0)
    assert len(a) == len(b) == 1000
    assert [r.due_s for r in a] != [r.due_s for r in b]
    # the same gaps: all but one of each schedule's are the other's
    gaps_a = Counter(round(y.due_s - x.due_s, 9) for x, y in zip(a, a[1:]))
    gaps_b = Counter(round(y.due_s - x.due_s, 9) for x, y in zip(b, b[1:]))
    assert sum((gaps_a & gaps_b).values()) >= len(a) - 3
    assert Counter((r.lane, len(r.rows)) for r in a) == Counter((r.lane, len(r.rows)) for r in b)
    assert all(0.0 <= r.due_s < 5.0 for r in a)


def test_mix():
    s = schedule(TRAFFIC, 3, 10.0)
    raw = [r for r in s if r.lane == "raw"]
    assert 0.15 < len(raw) / len(s) < 0.25
    assert all(2 <= len(r.rows) <= 16 for r in raw)
    assert all(len(r.rows) == 1 for r in s if r.lane == "wav")
    assert all(0 <= i < 64 for r in s for i in r.rows)


def test_latency_counts_from_due():
    s = schedule(TRAFFIC, 4, 1.0)[:3]
    done = {s[0].index: s[0].due_s + 0.010, s[1].index: s[1].due_s + 0.250, s[2].index: None}
    lat = latencies_ms(s, done)
    assert lat[0] == pytest.approx(10.0) and lat[1] == pytest.approx(250.0) and lat[2] == math.inf


def test_p95_over_all_requests_failures_infinite():
    values = [float(i) for i in range(1, 101)]
    assert percentile(values, 95.0) == 95.0
    assert percentile(values[:94] + [math.inf] * 6, 95.0) == math.inf
    assert percentile(values[:95] + [math.inf] * 5, 95.0) == 95.0
    assert percentile([3.0], 95.0) == 3.0
