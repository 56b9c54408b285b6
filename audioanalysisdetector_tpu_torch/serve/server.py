"""Online scoring service — dynamic micro-batching in front of one card.

Counterpart of the JAX package's ``serve/server.py``. The host-side
classes (``BatchingScorer``, ``ScoreServer``, ``ServeStats``, the bucket
ladder and the adaptive window) are that module's, unchanged in behaviour;
see its docstring for the design. What differs:

- ``build_mel_scorer`` builds the port's scorer (the mel kernel that
  ``frontend.mel.mel_route`` names + CNN-BiLSTM on CUDA); with
  ``data_parallel`` it splits each dispatch's rows over the local cards,
  one model replica each (the JAX package shards them over a one-process
  mesh). The multi-process front end is ``serve/multiproc.py``.
- ``/healthz`` reports the scorer's device type (``"cuda"`` or ``"cpu"``).
- The ``audio_b64`` lane decodes through the port's copy of ``io/``.
"""

from __future__ import annotations

import base64
import json
import os
import tempfile
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable

import numpy as np
import torch

from audioanalysisdetector_tpu_torch.utils.profiling import span

__all__ = [
    "BatchingScorer",
    "ScoreServer",
    "ServiceOverloaded",
    "build_mel_scorer",
]


class ServiceOverloaded(RuntimeError):
    """Raised when the request queue is full (mapped to HTTP 503)."""


def default_bucket_ladder(max_batch: int) -> tuple[int, ...]:
    """Powers-of-two dispatch-size ladder up to ``max_batch`` — the shared
    default for ``cli serve`` and any serving bench (one definition, so the
    measured ladder and the shipped ladder cannot drift)."""
    return tuple(sorted({max(1, int(max_batch) >> k) for k in range(3, -1, -1)}))


@dataclass
class ServeStats:
    """Counters exposed at ``GET /v1/stats`` (all monotonically increasing).

    The host-clock sums are sums and counts, not means, so that two
    snapshots subtract: ``queue_wait_s`` / ``popped`` is the mean wait of a
    slice from its arrival to the worker's pop, ``dispatch_s`` / ``batches``
    the mean scorer call of a dispatch (upload, score, fetch), and
    ``parse_s`` / ``parsed`` the mean time ``ScoreServer`` takes to turn a
    request body into rows (failed parses included). Each is added under
    the lock once per dispatch or request. Behind ``serve/multiproc.py``
    the owner's ``parse_s`` and ``parsed`` stay 0: the worker processes
    parse.
    """

    requests: int = 0
    utterances: int = 0
    batches: int = 0
    batch_rows: int = 0  # non-padding rows dispatched
    dispatched_rows: int = 0  # bucket rows dispatched (incl. padding)
    rejected: int = 0
    errors: int = 0
    early_ships: int = 0  # adaptive window closed before max_wait
    queue_wait_s: float = 0.0  # summed over popped slices: pop time - arrival
    popped: int = 0  # slices the worker popped off the queue
    dispatch_s: float = 0.0  # the scorer calls of the dispatches
    parse_s: float = 0.0  # request bodies turned into rows
    parsed: int = 0  # requests parsed
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def snapshot(self) -> dict:
        with self._lock:
            fill = (
                self.batch_rows / self.dispatched_rows if self.dispatched_rows else 0.0
            )
            return {
                "requests": self.requests,
                "utterances": self.utterances,
                "batches": self.batches,
                "mean_batch_fill": round(fill, 4),
                "rejected": self.rejected,
                "errors": self.errors,
                "early_ships": self.early_ships,
                "queue_wait_s": self.queue_wait_s,
                "popped": self.popped,
                "dispatch_s": self.dispatch_s,
                "parse_s": self.parse_s,
                "parsed": self.parsed,
            }

    def add_parse(self, seconds: float) -> None:
        with self._lock:
            self.parse_s += seconds
            self.parsed += 1


class _Pending:
    """One enqueued request slice: ``wav`` rows in, scores (or an error) out.

    ``cancelled`` marks a slice whose request was rejected after this slice
    was already queued (multi-slice request hitting a full queue mid-
    enqueue) — the worker discards it instead of wasting a dispatch on rows
    nobody will read, precisely when the chip is saturated.
    """

    __slots__ = ("wav", "done", "result", "error", "cancelled", "t_arrival")

    def __init__(self, wav: np.ndarray):
        self.wav = wav
        self.done = threading.Event()
        self.result: np.ndarray | None = None
        self.error: BaseException | None = None
        self.cancelled = False
        self.t_arrival = time.monotonic()  # feeds the adaptive-window EWMA


class BatchingScorer:
    """Dynamic micro-batcher around a ``(B, n) -> (B,)`` scorer.

    ``scorer`` is any callable taking a ``(max_batch, n_samples)`` float32
    array and returning ``(max_batch,)`` scores (``build_mel_scorer``
    produces these). ``score()`` is thread-safe and blocks until the worker
    has dispatched the rows and fetched the results.
    """

    def __init__(
        self,
        scorer: Callable[[np.ndarray], np.ndarray],
        *,
        n_samples: int,
        max_batch: int = 256,
        max_wait_ms: float = 5.0,
        queue_depth: int = 64,
        bucket_sizes: tuple[int, ...] | None = None,
        adaptive: bool = True,
    ):
        import queue as _queue

        self._scorer = scorer
        # the device the scorer runs on ("cuda" / "cpu"), for /healthz
        self.platform = str(getattr(scorer, "platform", "unknown"))
        self.n_samples = int(n_samples)
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1000.0
        # adaptive window: ``max_wait_ms`` stays the CAP, but the worker
        # ships as soon as the EWMA arrival-rate estimate says the next
        # dispatch-bucket boundary is unreachable within the remaining
        # window — waiting past that point buys no padding reduction, only
        # latency
        self.adaptive = bool(adaptive)
        self._ewma_gap: float | None = None  # s between request arrivals
        self._ewma_rows: float | None = None  # rows per arrival
        self._last_arrival: float | None = None
        # queue waits of the slices popped since the last dispatch (worker
        # thread only; added to the stats once per dispatch)
        self._waited = 0.0
        self._popped = 0
        # a data-parallel scorer shards dispatch rows over local devices
        # and needs every bucket divisible by the device count
        multiple = int(getattr(scorer, "row_multiple", 1) or 1)
        if self.max_batch % multiple:
            raise ValueError(
                f"max_batch {self.max_batch} not divisible by the scorer's "
                f"row multiple {multiple}"
            )
        # dispatch-size ladder: a partial batch pads up to the smallest
        # bucket that holds it instead of always to max_batch: one warm-up
        # per bucket (warm_up), proportional upload + compute saved on every
        # partial dispatch.
        if bucket_sizes:
            ladder = sorted(
                -(-int(b) // multiple) * multiple for b in bucket_sizes
            )
            if ladder[-1] != self.max_batch:
                raise ValueError("bucket_sizes must end at max_batch")
            self.bucket_sizes: tuple[int, ...] = tuple(dict.fromkeys(ladder))
        else:
            self.bucket_sizes = (self.max_batch,)
        self.stats = ServeStats()
        self._q: "_queue.Queue[_Pending | None]" = _queue.Queue(maxsize=queue_depth)
        self._carry: _Pending | None = None  # overflow item held for the next batch
        self._stop = threading.Event()
        # serializes "check _stop + enqueue" against close()'s final drain,
        # so a request can never slip into the queue after the worker exited
        # (it would otherwise block until the request timeout)
        self._enqueue_lock = threading.Lock()
        self._worker = threading.Thread(
            target=self._run, name="batching-scorer", daemon=True
        )
        self._worker.start()

    # ---- client side -----------------------------------------------------

    def score(self, wav: np.ndarray, *, timeout: float = 60.0) -> np.ndarray:
        """Score ``(k, n_samples)`` (or ``(n_samples,)``) rows; returns ``(k,)``.

        Requests larger than ``max_batch`` are split into consecutive
        dispatch slices transparently. Raises :class:`ServiceOverloaded`
        when the bounded queue is full, ``TimeoutError`` past ``timeout``.
        """
        import queue as _queue

        wav = np.asarray(wav, dtype=np.float32)
        if wav.ndim == 1:
            wav = wav[None, :]
        if wav.ndim != 2 or wav.shape[1] != self.n_samples:
            raise ValueError(
                f"expected (k, {self.n_samples}) waveform rows, got {wav.shape}"
            )
        slices = [
            _Pending(wav[i : i + self.max_batch])
            for i in range(0, len(wav), self.max_batch)
        ]
        enqueued: list[_Pending] = []

        def _abandon(exc: BaseException) -> None:
            # best-effort: slices the worker hasn't popped yet are skipped
            # at pop time, so a dead request doesn't burn device dispatches
            for p in slices:
                if not p.done.is_set():
                    p.cancelled = True
            raise exc

        for p in slices:
            # the lock serializes ONLY "check _stop + put_nowait" against
            # close()'s final drain; the backpressure wait happens with the
            # lock RELEASED, so one large request under a full queue can't
            # head-of-line-block every other request's enqueue (or close())
            slice_deadline = time.monotonic() + 0.5
            while True:
                with self._enqueue_lock:
                    if self._stop.is_set():
                        _abandon(RuntimeError("BatchingScorer is closed"))
                    try:
                        self._q.put_nowait(p)
                        enqueued.append(p)
                        break
                    except _queue.Full:
                        pass
                if time.monotonic() >= slice_deadline:
                    with self.stats._lock:
                        self.stats.rejected += 1
                    _abandon(ServiceOverloaded(
                        "request queue full — the chip is saturated; "
                        "retry with backoff"
                    ))
                time.sleep(0.005)
        with self.stats._lock:
            self.stats.requests += 1
            self.stats.utterances += len(wav)
        deadline = time.monotonic() + timeout
        for p in slices:
            if not p.done.wait(max(0.0, deadline - time.monotonic())):
                _abandon(TimeoutError(f"scoring timed out after {timeout}s"))
            if p.error is not None:
                _abandon(p.error)
        return np.concatenate([p.result for p in slices])

    def close(self) -> None:
        """Stop the worker; in-flight requests finish, new ones are refused."""
        import queue as _queue

        if not self._stop.is_set():
            self._stop.set()
            self._q.put(None)  # wake the worker
            self._worker.join(timeout=30.0)
        # fail anything that raced past the _stop check into the queue —
        # under _enqueue_lock, so no new put can interleave with the drain
        with self._enqueue_lock:
            while True:
                try:
                    p = self._q.get_nowait()
                except _queue.Empty:
                    break
                if p is not None:
                    p.error = RuntimeError("BatchingScorer is closed")
                    p.done.set()

    # ---- device worker ---------------------------------------------------

    def _note_arrival(self, p: "_Pending") -> None:
        """Update the EWMA inter-arrival gap / rows-per-arrival estimators
        from an item's enqueue timestamp (called once per queue pop), and
        count the item's wait in the queue."""
        self._waited += time.monotonic() - p.t_arrival
        self._popped += 1
        if self._last_arrival is not None:
            gap = p.t_arrival - self._last_arrival
            # clamp idle stretches so one quiet period doesn't poison the
            # estimator for the next burst
            gap = max(0.0, min(gap, 10.0 * self.max_wait_s))
            self._ewma_gap = (
                gap if self._ewma_gap is None else 0.8 * self._ewma_gap + 0.2 * gap
            )
        self._last_arrival = max(self._last_arrival or 0.0, p.t_arrival)
        r = float(len(p.wav))
        self._ewma_rows = (
            r if self._ewma_rows is None else 0.8 * self._ewma_rows + 0.2 * r
        )

    def _adaptive_wait(self, rows: int, remaining: float) -> float:
        """Seconds worth waiting for more rows, given ``rows`` collected and
        ``remaining`` window: the ETA to the next bucket boundary while the
        arrival-rate estimate says it is reachable within the window, else
        0 (pad-up cost is already sunk — waiting longer only adds
        latency). Waiting the ETA rather than the full remainder bounds the
        loss when the prediction misses."""
        gap, rpp = self._ewma_gap, self._ewma_rows
        if gap is None or rpp is None:
            return remaining  # no estimate yet: behave like the fixed window
        next_boundary = next(b for b in self.bucket_sizes if b > rows)
        arrivals_needed = -(-(next_boundary - rows) // max(int(rpp), 1))
        eta = arrivals_needed * gap
        return min(eta, remaining) if eta <= remaining else 0.0

    def _collect(self) -> list[_Pending] | None:
        """Block for the first item, then gather rows until the window
        closes, the row budget fills, or (adaptive mode) the arrival-rate
        estimate says the next bucket boundary is out of reach. Returns
        None on shutdown wake."""
        import queue as _queue

        first = None
        if self._carry is not None and not self._carry.cancelled:
            first = self._carry  # arrival already noted at its queue pop
        self._carry = None
        while first is None:
            first = self._q.get()
            if first is None:
                return None
            self._note_arrival(first)
            if first.cancelled:  # rejected mid-enqueue: discard silently
                first = None
        batch = [first]
        rows = len(first.wav)
        deadline = time.monotonic() + self.max_wait_s
        with span("serve.collect"):
            while rows < self.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                item: _Pending | None
                if self.adaptive:
                    try:  # drain whatever already queued without blocking
                        item = self._q.get_nowait()
                    except _queue.Empty:
                        wait = self._adaptive_wait(rows, remaining)
                        if wait <= 0.0:
                            with self.stats._lock:
                                self.stats.early_ships += 1
                            break
                        try:
                            item = self._q.get(timeout=wait)
                        except _queue.Empty:
                            if wait < remaining:  # gave up before the cap
                                with self.stats._lock:
                                    self.stats.early_ships += 1
                            break
                else:
                    try:
                        item = self._q.get(timeout=remaining)
                    except _queue.Empty:
                        break
                if item is None:  # shutdown sentinel: ship what we have
                    self._stop.set()
                    break
                self._note_arrival(item)
                if item.cancelled:
                    continue
                if rows + len(item.wav) > self.max_batch:
                    self._carry = item  # starts the next batch
                    break
                batch.append(item)
                rows += len(item.wav)
        return batch

    def warm_up(self) -> None:
        """Run every bucket shape once before accepting traffic (the first
        call builds the kernel and warms the constant caches and cuDNN)."""
        for b in self.bucket_sizes:
            np.asarray(self._scorer(np.zeros((b, self.n_samples), np.float32)))

    def _bucket(self, rows: int) -> int:
        for b in self.bucket_sizes:
            if b >= rows:
                return b
        return self.max_batch

    def _add_waits_locked(self, dispatch_s: float) -> None:
        """Add one dispatch's scorer time and the queue waits of the slices
        popped since the last dispatch; the caller holds the stats lock."""
        self.stats.dispatch_s += dispatch_s
        self.stats.queue_wait_s += self._waited
        self.stats.popped += self._popped
        self._waited, self._popped = 0.0, 0

    def _run(self) -> None:
        while True:
            batch = self._collect()
            if batch is None:
                return
            rows = sum(len(p.wav) for p in batch)
            mat = np.zeros((self._bucket(rows), self.n_samples), dtype=np.float32)
            off = 0
            for p in batch:
                mat[off : off + len(p.wav)] = p.wav
                off += len(p.wav)
            t0 = time.monotonic()
            try:
                with span("serve.dispatch"):
                    scores = np.asarray(self._scorer(mat)).reshape(-1)
                dispatch_s = time.monotonic() - t0
                off = 0
                for p in batch:
                    p.result = scores[off : off + len(p.wav)].copy()
                    off += len(p.wav)
                with self.stats._lock:
                    self.stats.batches += 1
                    self.stats.batch_rows += rows
                    self.stats.dispatched_rows += len(mat)
                    self._add_waits_locked(dispatch_s)
            except BaseException as e:  # noqa: BLE001 — delivered per-request
                for p in batch:
                    p.error = e
                with self.stats._lock:
                    self.stats.errors += 1
                    self._add_waits_locked(time.monotonic() - t0)
            finally:
                for p in batch:
                    p.done.set()
            if self._stop.is_set() and self._carry is None and self._q.empty():
                return


def _decode_b64_audio(b64: str, fmt: str, sr: int) -> np.ndarray:
    """base64 WAV/FLAC bytes -> float32 mono waveform at ``sr``.

    The in-repo decoders are path-based (they exist to serve corpus files),
    so uploads round-trip through a temp file — negligible next to decode
    itself, and it keeps one decode implementation.
    """
    from audioanalysisdetector_tpu_torch.io.audio import load_audio

    if not isinstance(fmt, str):
        raise ValueError(f"'format' must be a string, got {type(fmt).__name__}")
    fmt = fmt.lower().lstrip(".")
    if fmt not in ("wav", "flac"):
        raise ValueError(f"unsupported audio format {fmt!r} (wav|flac)")
    raw = base64.b64decode(b64, validate=True)
    fd, path = tempfile.mkstemp(suffix="." + fmt)
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(raw)
        y, _ = load_audio(path, sr=sr)
    finally:
        os.unlink(path)
    return y


def _fit_rows(y: np.ndarray, n_samples: int) -> np.ndarray:
    """Pad/crop 1-D or 2-D PCM to the service's fixed row length."""
    y = np.atleast_2d(np.asarray(y, dtype=np.float32))
    if y.ndim != 2:
        raise ValueError(f"pcm must be 1-D or 2-D, got ndim={y.ndim}")
    if y.size == 0:
        # an empty payload would otherwise zero-pad into a fabricated
        # silent row and come back with a confident score
        raise ValueError("empty audio payload")
    out = np.zeros((y.shape[0], n_samples), dtype=np.float32)
    n = min(y.shape[1], n_samples)
    out[:, :n] = y[:, :n]
    return out


class _HTTPServer(ThreadingHTTPServer):
    # socketserver's listen backlog is 5: a burst of more clients than that
    # connecting at once loses SYNs, and each lost one costs its client a
    # 1-s retransmit. The owner's unix socket (serve/multiproc.py) holds 128.
    request_queue_size = 128


class ScoreServer:
    """Threaded HTTP front end over a :class:`BatchingScorer`.

    Endpoints (JSON in/out):

    - ``POST /v1/score`` — body one of ``{"pcm": [[...]...]}`` (float rows
      at the service sample rate; padded/cropped to the chunk length),
      ``{"pcm_b64": "...", "rows": k}`` (base64 little-endian float32 —
      the production lane, no per-float JSON parsing), or
      ``{"audio_b64": "...", "format": "wav"|"flac"}`` (an encoded file,
      decoded on the host and resampled to the service rate). Response
      ``{"scores": [...], "labels": [...]}``
      with the reference's 0.5 decision threshold
      (reference/ASV_dl_func.py:1491).
    - ``POST /v1/score_raw`` — body is raw little-endian float32 rows
      (``Content-Type: application/octet-stream``, row count in an
      ``X-Rows`` header, default 1). Skips base64 (4/3 payload inflation)
      and JSON body parsing entirely — the fastest lane on the host, which
      the JAX package's serving decomposition found to be the host's
      throughput ceiling. Same JSON response as ``/v1/score``.
    - ``GET /healthz`` — liveness + the service's fixed-shape contract.
    - ``GET /v1/stats`` — batching counters (see :class:`ServeStats`).
    """

    MAX_BODY = 256 * 1024 * 1024

    def __init__(
        self,
        batcher: BatchingScorer,
        *,
        sr: int,
        host: str = "127.0.0.1",
        port: int = 0,
        request_timeout: float = 60.0,
        reuse_port: bool = False,
    ):
        self.batcher = batcher
        self.sr = int(sr)
        self.request_timeout = float(request_timeout)
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):  # quiet by default; stats carry the signal
                pass

            def _reply(self, code: int, payload: dict) -> None:
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    self._reply(200, outer._health())
                elif self.path == "/v1/stats":
                    self._reply(200, outer.batcher.stats.snapshot())
                else:
                    self._reply(404, {"error": f"no route {self.path}"})

            def do_POST(self):
                if self.path not in ("/v1/score", "/v1/score_raw"):
                    self._reply(404, {"error": f"no route {self.path}"})
                    return
                try:
                    length = int(self.headers.get("Content-Length", "0"))
                    if length > outer.MAX_BODY:
                        # the body is left unread — close the connection so
                        # a keep-alive client can't desync the next request
                        # against the leftover body bytes
                        self.close_connection = True
                        self._reply(413, {"error": "body too large"})
                        return
                    body = self.rfile.read(length)
                    rows = outer._parse(self.path, body, self.headers.get("X-Rows", "1"))
                    scores = outer.batcher.score(
                        rows, timeout=outer.request_timeout
                    )
                except ServiceOverloaded as e:
                    self._reply(503, {"error": str(e)})
                except TimeoutError as e:
                    self._reply(504, {"error": str(e)})
                except (ValueError, KeyError, TypeError, json.JSONDecodeError) as e:
                    # TypeError covers malformed field types the explicit
                    # checks miss — still the client's error, not a 500
                    self._reply(400, {"error": str(e)})
                except Exception as e:  # noqa: BLE001 — scorer faults -> 500
                    self._reply(500, {"error": f"{type(e).__name__}: {e}"})
                else:
                    self._reply(
                        200,
                        {
                            "scores": [float(s) for s in scores],
                            "labels": [int(s > 0.5) for s in scores],
                        },
                    )

        if reuse_port:
            # multi-process mode (serve/multiproc.py): every worker binds
            # the same concrete port; the kernel load-balances connections
            # across the reuseport group
            import socket as _socket

            class _ReusePortServer(_HTTPServer):
                def server_bind(self):
                    self.socket.setsockopt(_socket.SOL_SOCKET, _socket.SO_REUSEPORT, 1)
                    _HTTPServer.server_bind(self)

            self._httpd = _ReusePortServer((host, port), Handler)
        else:
            self._httpd = _HTTPServer((host, port), Handler)
        self._thread: threading.Thread | None = None

    # ---- request assembly ----

    def _parse(self, path: str, body: bytes, rows_header: str) -> np.ndarray:
        """The rows of one request body, under the ``serve.parse`` span and
        timed into the stats' ``parse_s`` / ``parsed``."""
        t0 = time.monotonic()
        try:
            with span("serve.parse"):
                if path == "/v1/score_raw":
                    return self._rows_from_raw(body, rows_header)
                return self._rows_from_request(json.loads(body))
        finally:
            self.batcher.stats.add_parse(time.monotonic() - t0)

    def _rows_from_request(self, req: dict) -> np.ndarray:
        if "pcm_b64" in req:
            # binary lane: little-endian float32 rows, base64-wrapped — a
            # 2-s utterance is 128 KB of payload instead of ~700 KB of JSON
            # floats, and numpy's frombuffer replaces per-float JSON parsing
            raw = np.frombuffer(
                base64.b64decode(req["pcm_b64"], validate=True), dtype="<f4"
            )
            rows = req.get("rows", 1)
            if not isinstance(rows, int) or isinstance(rows, bool):
                raise ValueError(f"'rows' must be an integer, got {rows!r}")
            if rows < 1 or len(raw) % rows != 0:
                raise ValueError(
                    f"pcm_b64 length {len(raw)} not divisible into {rows} rows"
                )
            return _fit_rows(raw.reshape(rows, -1), self.batcher.n_samples)
        if "pcm" in req:
            return _fit_rows(np.asarray(req["pcm"]), self.batcher.n_samples)
        if "audio_b64" in req:
            y = _decode_b64_audio(req["audio_b64"], req.get("format", "wav"), self.sr)
            return _fit_rows(y, self.batcher.n_samples)
        raise KeyError("request needs 'pcm', 'pcm_b64', or 'audio_b64'")

    def _rows_from_raw(self, body: bytes, rows_header: str) -> np.ndarray:
        """/v1/score_raw assembly: raw ``<f4`` rows, count from ``X-Rows``.

        np.frombuffer is zero-copy over the request body; _fit_rows then
        pads/crops to the service chunk length like every other lane."""
        try:
            rows = int(rows_header)
        except ValueError:
            raise ValueError(f"X-Rows must be an integer, got {rows_header!r}")
        if len(body) % 4 != 0:
            raise ValueError(f"body length {len(body)} not a float32 multiple")
        raw = np.frombuffer(body, dtype="<f4")
        if rows < 1 or len(raw) % rows != 0:
            raise ValueError(
                f"body of {len(raw)} floats not divisible into {rows} rows"
            )
        return _fit_rows(raw.reshape(rows, -1), self.batcher.n_samples)

    def _health(self) -> dict:
        return {
            "ok": True,
            "platform": self.batcher.platform,
            "sr": self.sr,
            "n_samples": self.batcher.n_samples,
            "max_batch": self.batcher.max_batch,
        }

    # ---- lifecycle ----

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start_background(self) -> None:
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="score-server", daemon=True
        )
        self._thread.start()

    def serve_forever(self) -> None:
        self._httpd.serve_forever()

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        self.batcher.close()


def build_mel_scorer(
    *,
    checkpoint: str | None = None,
    sr: int = 16000,
    seconds: float = 2.0,
    n_mels: int = 64,
    mel_profile: str = "parity",
    data_parallel: bool | None = None,
    device: str | torch.device = "cuda",
    seed: int = 0,
) -> tuple[Callable[[np.ndarray], np.ndarray], int]:
    """(scorer, n_samples) for the flagship mel -> CNN-BiLSTM service on
    ``device``: numpy ``(B, n_samples)`` float32 in, numpy ``(B,)`` out.

    Model init + checkpoint loading go through
    ``score.e2e.init_mel_cnn_bilstm``, the one checkpoint contract. The
    scorer carries ``row_multiple`` for the batcher's bucket ladder and
    ``platform`` (the device type) for ``/healthz``.

    ``data_parallel`` (None = auto when ``device`` is CUDA and more than one
    card is visible): one replica of the model per card, each dispatch's
    rows split evenly over them (scoring is per row: no collectives), the
    scores gathered in row order. ``row_multiple`` is then the card count,
    and a dispatch whose rows do not divide raises. ``True`` on one device
    raises, as in the JAX package.
    """
    from audioanalysisdetector_tpu_torch.frontend.mel import MelConfig
    from audioanalysisdetector_tpu_torch.parallel.mesh import split_rows_over
    from audioanalysisdetector_tpu_torch.score.e2e import (
        init_mel_cnn_bilstm,
        make_mel_cnn_bilstm_scorer,
    )

    device = torch.device(device)
    n_dev = torch.cuda.device_count() if device.type == "cuda" else 1
    if data_parallel is True and n_dev <= 1:
        # an explicit request for sharding on a single device is an
        # operator error, not a silent no-op
        raise ValueError("data_parallel=True but only one local device")
    use_dp = n_dev > 1 if data_parallel is None else data_parallel
    devices = [torch.device("cuda", i) for i in range(n_dev)] if use_dp else [device]
    mel_cfg = MelConfig.for_profile(mel_profile, sr, n_mels=n_mels)
    n_samples = int(seconds * sr)
    scores = [
        make_mel_cnn_bilstm_scorer(
            init_mel_cnn_bilstm(mel_cfg, n_samples, checkpoint=checkpoint, seed=seed, device=d), mel_cfg
        )
        for d in devices
    ]

    def scorer(wav: np.ndarray) -> np.ndarray:
        batch = torch.from_numpy(np.ascontiguousarray(wav, dtype=np.float32))
        return split_rows_over(devices, scores, batch).numpy()

    scorer.row_multiple = len(devices)
    scorer.platform = device.type
    return scorer, n_samples
