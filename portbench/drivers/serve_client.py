#!/usr/bin/env python3
"""One client process of a serving cell's open loop.

    python3 serve_client.py --port P --seed S --seconds T --traffic FILE --index i --of k --sr SR \
        --n-samples N --threads M

It makes the cell's utterance pool from the seed (``harness/audio.py::waves_np``),
encodes it (16-bit WAV in base64 JSON for ``/v1/score``, raw float32 rows
for ``/v1/score_raw``), takes every ``k``-th request of the schedule
(``harness/openloop.py``) from the ``i``-th. Its worker threads each open
a keep-alive connection and send one request of each lane (set-up, not
timed); then it prints ``ready`` and waits for ``go <t0>`` on standard
input, ``t0`` a ``time.monotonic()`` instant, which
is the same clock in every process of the machine. The threads send each
request when it is due or,
when all are busy, as soon as one is free; a request that waits is late,
and its latency counts from when it was due. Once every request has an
answer or a minute has passed since the window closed, it prints one JSON
line: per request its index, the answer's offset from ``t0`` (null when
it failed), the HTTP status and the scores.
"""

from __future__ import annotations

import argparse
import base64
import http.client
import io
import json
import sys
import threading
import time
import wave
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from portbench.harness.audio import waves_np  # noqa: E402
from portbench.harness.openloop import schedule  # noqa: E402


def wav_body(q, sr: int) -> bytes:
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(q.astype("<i2").tobytes())
    return json.dumps({"audio_b64": base64.b64encode(buf.getvalue()).decode(), "format": "wav"}).encode()


def main() -> int:
    p = argparse.ArgumentParser()
    for name in ("--port", "--seed", "--index", "--of", "--sr", "--n-samples"):
        p.add_argument(name, type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--traffic", required=True)
    p.add_argument("--threads", type=int, required=True)
    args = p.parse_args()
    traffic = json.loads(Path(args.traffic).read_text())
    mine = [r for r in schedule(traffic, args.seed, args.seconds) if r.index % args.of == args.index]
    pool = waves_np(int(traffic["pool_utterances"]), args.n_samples, args.sr, args.seed, traffic["audio"])
    wavs: dict[int, bytes] = {}
    raws = [(q.astype("<f4") / 32768.0).astype("<f4").tobytes() for q in pool]
    for r in mine:
        if r.lane == "wav" and r.rows[0] not in wavs:
            wavs[r.rows[0]] = wav_body(pool[r.rows[0]], args.sr)
    results: dict[int, list] = {}
    lock = threading.Lock()
    pending = list(reversed(mine))
    go = threading.Event()
    ready = threading.Barrier(args.threads + 1)
    clock = {}

    def send(conn, lane: str, rows) -> tuple[int, list | None]:
        if lane == "wav":
            path, body, hdr = "/v1/score", wavs.get(rows[0]) or wav_body(pool[rows[0]], args.sr), \
                {"Content-Type": "application/json"}
        else:
            path, body = "/v1/score_raw", b"".join(raws[i] for i in rows)
            hdr = {"Content-Type": "application/octet-stream", "X-Rows": str(len(rows))}
        conn.request("POST", path, body=body, headers=hdr)
        resp = conn.getresponse()
        payload = resp.read()
        return resp.status, (json.loads(payload)["scores"] if resp.status == 200 else None)

    def worker() -> None:
        # set-up: open the connection and send one request of each lane
        conn = http.client.HTTPConnection("127.0.0.1", args.port, timeout=120)
        send(conn, "wav", (0,))
        send(conn, "raw", (0, 1))
        ready.wait()
        go.wait()
        t0, give_up = clock["t0"], clock["give_up"]
        while True:
            with lock:
                if not pending:
                    break
                r = pending.pop()
            wait = t0 + r.due_s - time.monotonic()
            if wait > 0:
                time.sleep(wait)
            status, scores, done = 0, None, None
            try:
                if conn is None:
                    conn = http.client.HTTPConnection("127.0.0.1", args.port,
                                                      timeout=max(1.0, give_up - time.monotonic()))
                status, scores = send(conn, r.lane, r.rows)
                if status == 200:
                    done = time.monotonic() - t0
            except (OSError, http.client.HTTPException, ValueError):
                conn = None  # reconnect for the next request; this one failed
            with lock:
                results[r.index] = [r.index, done, status, scores]
        if conn is not None:
            conn.close()

    threads = [threading.Thread(target=worker, daemon=True) for _ in range(args.threads)]
    for t in threads:
        t.start()
    ready.wait()
    print("ready", flush=True)
    clock["t0"] = float(sys.stdin.readline().split()[1])
    clock["give_up"] = clock["t0"] + args.seconds + 60.0
    go.set()
    for t in threads:
        t.join(timeout=max(0.0, clock["give_up"] - time.monotonic()) + 5.0)
    with lock:
        out = [results.get(r.index, [r.index, None, 0, None]) for r in mine]
    print(json.dumps({"results": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
