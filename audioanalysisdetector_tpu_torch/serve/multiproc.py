"""Multi-process serving: N HTTP workers sharing one port, one card owner (PyTorch).

Counterpart of the JAX package's ``serve/multiproc.py``. The
single-process :class:`~audioanalysisdetector_tpu_torch.serve.server.ScoreServer`
parses and assembles requests on the host under one GIL, so scaling the
host side means more *processes*:

- **N HTTP worker processes** each bind the same ``(host, port)`` with
  ``SO_REUSEPORT``; the kernel load-balances incoming connections across
  them, so no front proxy is needed and adding a worker is adding a core.
  Workers never touch the card: the parent spawns them with
  ``CUDA_VISIBLE_DEVICES`` empty, and they import nothing that launches
  CUDA work — they parse, decode, validate and forward.
- **One device-owner process** owns the card and the
  :class:`BatchingScorer`. Every worker forwards assembled float32 rows
  to it over a framed unix-domain-socket protocol, so micro-batching
  aggregates the traffic of all workers.

Wire protocol (all little-endian), the JAX package's:

- request frame: ``op:u8, len:u32, payload``; ops ``INFO=1`` (empty),
  ``SCORE=2`` (``rows:u32, timeout:f64, rows×n_samples float32``),
  ``STATS=3`` (empty).
- reply frame: ``status:u8, len:u32, payload`` — status 0 OK (payload:
  JSON for INFO/STATS, float32 scores for SCORE), 1 overloaded, 2 timeout,
  3 bad request, 4 internal error (payload: utf-8 message).

The owner's STATS reply adds ``kernel_launches``: its process's launch
counts (``ops.launch_counts``), which no worker can see.
"""

from __future__ import annotations

import contextlib
import importlib
import json
import os
import socket
import socketserver
import struct
import tempfile
import threading
import time

import numpy as np

__all__ = ["DeviceOwner", "RemoteScorer", "MultiprocessServer"]

_OP_INFO, _OP_SCORE, _OP_STATS = 1, 2, 3
_ST_OK, _ST_OVERLOADED, _ST_TIMEOUT, _ST_BAD, _ST_INTERNAL = 0, 1, 2, 3, 4
_HDR = struct.Struct("<BI")
_SCORE_HDR = struct.Struct("<Id")


def _send_frame(sock: socket.socket, code: int, payload: bytes = b"") -> None:
    sock.sendall(_HDR.pack(code, len(payload)) + payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(n - len(buf), 1 << 20))
        if not chunk:
            raise ConnectionError("peer closed mid-frame")
        buf += chunk
    return bytes(buf)


def _recv_frame(sock: socket.socket) -> tuple[int, bytes]:
    code, length = _HDR.unpack(_recv_exact(sock, _HDR.size))
    return code, _recv_exact(sock, length) if length else b""


def resolve_factory(spec: str):
    """``"pkg.module:function"`` -> the callable. Factories must be
    importable top-level functions (they cross a ``spawn`` boundary)."""
    mod, _, fn = spec.partition(":")
    if not fn:
        raise ValueError(f"factory spec {spec!r} must be 'module:function'")
    return getattr(importlib.import_module(mod), fn)


def default_mel_factory(**kwargs):
    """The flagship mel->CNN-BiLSTM scorer (build_mel_scorer passthrough)."""
    from audioanalysisdetector_tpu_torch.serve.server import build_mel_scorer

    return build_mel_scorer(**kwargs)


def noop_scorer_factory(n_samples: int = 32000):
    """Zero-score factory with no device work: the host ceiling of the
    serving path (everything except the device round trip)."""

    def scorer(batch):
        return np.zeros(len(batch), np.float32)

    return scorer, int(n_samples)


class DeviceOwner:
    """Unix-socket daemon wrapping the process's :class:`BatchingScorer`.

    One instance runs in the single process that owns the card; every
    HTTP worker holds client connections to it. Connections are handled
    by threads that block in ``batcher.score``, exactly like the
    single-process server's HTTP threads, so the batcher's window sees the
    union of all workers' traffic.
    """

    def __init__(self, sock_path: str, batcher, *, platform: str = "unknown"):
        self.batcher = batcher
        self.platform = platform
        owner = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                sock = self.request
                try:
                    while True:
                        try:
                            op, payload = _recv_frame(sock)
                        except ConnectionError:
                            return
                        owner._dispatch(sock, op, payload)
                except (BrokenPipeError, ConnectionResetError):
                    return

        class Server(socketserver.ThreadingUnixStreamServer):
            daemon_threads = True
            # every worker's HTTP threads connect at once; socketserver's
            # listen backlog of 5 fails the rest with EAGAIN on some kernels
            # (an H100 host's kernel did so at 4 workers and 16 clients)
            request_queue_size = 128

        if os.path.exists(sock_path):
            os.unlink(sock_path)
        self._server = Server(sock_path, Handler)
        self.sock_path = sock_path
        self._thread: threading.Thread | None = None

    def _stats(self) -> dict:
        from audioanalysisdetector_tpu_torch.ops import launch_counts

        return {**self.batcher.stats.snapshot(), "kernel_launches": launch_counts()}

    def _dispatch(self, sock: socket.socket, op: int, payload: bytes) -> None:
        from audioanalysisdetector_tpu_torch.serve.server import ServiceOverloaded

        if op == _OP_INFO:
            info = {
                "n_samples": self.batcher.n_samples,
                "max_batch": self.batcher.max_batch,
                "platform": self.platform,
                "bucket_sizes": list(self.batcher.bucket_sizes),
                "adaptive": self.batcher.adaptive,
            }
            _send_frame(sock, _ST_OK, json.dumps(info).encode())
        elif op == _OP_STATS:
            _send_frame(sock, _ST_OK, json.dumps(self._stats()).encode())
        elif op == _OP_SCORE:
            try:
                rows, timeout = _SCORE_HDR.unpack_from(payload)
                wav = np.frombuffer(payload, dtype="<f4", offset=_SCORE_HDR.size)
                if rows < 1 or wav.size != rows * self.batcher.n_samples:
                    raise ValueError(
                        f"payload of {wav.size} floats is not {rows} rows of "
                        f"{self.batcher.n_samples}"
                    )
                scores = self.batcher.score(wav.reshape(rows, -1), timeout=timeout)
            except ServiceOverloaded as e:
                _send_frame(sock, _ST_OVERLOADED, str(e).encode())
            except TimeoutError as e:
                _send_frame(sock, _ST_TIMEOUT, str(e).encode())
            except (ValueError, struct.error) as e:
                _send_frame(sock, _ST_BAD, str(e).encode())
            except Exception as e:  # noqa: BLE001 — delivered to the worker
                _send_frame(sock, _ST_INTERNAL, f"{type(e).__name__}: {e}".encode())
            else:
                _send_frame(sock, _ST_OK, np.asarray(scores, dtype="<f4").tobytes())
        else:
            _send_frame(sock, _ST_BAD, f"unknown op {op}".encode())

    def start_background(self) -> None:
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="device-owner", daemon=True
        )
        self._thread.start()

    def serve_forever(self) -> None:
        self._server.serve_forever()

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        self.batcher.close()
        if os.path.exists(self.sock_path):
            os.unlink(self.sock_path)


class _RemoteStats:
    """``stats.snapshot()`` proxy so ScoreServer's /v1/stats endpoint reads
    the owner's GLOBAL batching counters (the union over all workers)."""

    def __init__(self, scorer: "RemoteScorer"):
        self._scorer = scorer

    def snapshot(self) -> dict:
        return self._scorer._request_json(_OP_STATS)

    def add_parse(self, seconds: float) -> None:
        """Parsing runs in the worker processes: the owner's ``parse_s`` and
        ``parsed`` stay 0."""


class RemoteScorer:
    """Client-side duck type of :class:`BatchingScorer` over the owner socket.

    ``ScoreServer`` needs ``n_samples``, ``max_batch``, ``platform``,
    ``score()``, ``stats.snapshot()``, ``close()``: this provides all of
    them by forwarding frames, with one socket per calling thread (HTTP
    handler threads each keep a persistent connection; no lock contention
    on the hot path)."""

    def __init__(self, sock_path: str, *, connect_timeout: float = 300.0):
        self.sock_path = sock_path
        self._local = threading.local()
        self._closed = False
        # fetch the service contract (also the readiness wait: the owner
        # only answers once its batcher is warmed up and bound)
        deadline = time.monotonic() + connect_timeout
        while True:
            try:
                info = self._request_json(_OP_INFO)
                break
            except (ConnectionError, FileNotFoundError, OSError) as e:
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"device owner at {sock_path} not ready: {e}") from e
                time.sleep(0.1)
        self.n_samples = int(info["n_samples"])
        self.max_batch = int(info["max_batch"])
        self.platform = str(info["platform"])
        self.bucket_sizes = tuple(info["bucket_sizes"])
        self.adaptive = bool(info["adaptive"])
        self.stats = _RemoteStats(self)

    def _conn(self) -> socket.socket:
        sock = getattr(self._local, "sock", None)
        if sock is None:
            sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            sock.connect(self.sock_path)
            self._local.sock = sock
        return sock

    def _drop_conn(self) -> None:
        sock = getattr(self._local, "sock", None)
        if sock is not None:
            try:
                sock.close()
            finally:
                self._local.sock = None

    def _roundtrip(self, op: int, payload: bytes, timeout: float) -> tuple[int, bytes]:
        if self._closed:
            raise RuntimeError("RemoteScorer is closed")
        for attempt in (0, 1):  # one transparent reconnect on a stale conn
            sock = self._conn()
            try:
                sock.settimeout(timeout)
                _send_frame(sock, op, payload)
                return _recv_frame(sock)
            except (ConnectionError, BrokenPipeError, socket.timeout, OSError):
                self._drop_conn()
                if attempt:
                    raise
        raise AssertionError("unreachable")

    def _request_json(self, op: int, timeout: float = 30.0) -> dict:
        status, payload = self._roundtrip(op, b"", timeout)
        if status != _ST_OK:
            raise RuntimeError(payload.decode(errors="replace"))
        return json.loads(payload)

    def score(self, wav: np.ndarray, *, timeout: float = 60.0) -> np.ndarray:
        from audioanalysisdetector_tpu_torch.serve.server import ServiceOverloaded

        wav = np.ascontiguousarray(wav, dtype="<f4")
        if wav.ndim == 1:
            wav = wav[None, :]
        if wav.ndim != 2 or wav.shape[1] != self.n_samples:
            raise ValueError(f"expected (k, {self.n_samples}) waveform rows, got {wav.shape}")
        payload = _SCORE_HDR.pack(len(wav), timeout) + wav.tobytes()
        # the socket deadline outlives the batcher's own timeout, so the
        # owner's TimeoutError arrives as a frame, not a raw socket drop
        status, reply = self._roundtrip(_OP_SCORE, payload, timeout + 10.0)
        if status == _ST_OK:
            return np.frombuffer(reply, dtype="<f4").astype(np.float32)
        msg = reply.decode(errors="replace")
        if status == _ST_OVERLOADED:
            raise ServiceOverloaded(msg)
        if status == _ST_TIMEOUT:
            raise TimeoutError(msg)
        if status == _ST_BAD:
            raise ValueError(msg)
        raise RuntimeError(msg)

    def close(self) -> None:
        # per-thread sockets die with their threads; mark closed so the
        # owning ScoreServer's lifecycle matches BatchingScorer's
        self._closed = True
        self._drop_conn()


# ---- process entry points (spawn targets: importable, picklable args) ----


def _owner_entry(
    sock_path: str,
    factory_spec: str,
    factory_kwargs: dict,
    batcher_kwargs: dict,
    ready_event,
) -> None:
    from audioanalysisdetector_tpu_torch.serve.server import BatchingScorer

    scorer, n_samples = resolve_factory(factory_spec)(**factory_kwargs)
    batcher = BatchingScorer(scorer, n_samples=n_samples, **batcher_kwargs)
    batcher.warm_up()
    owner = DeviceOwner(sock_path, batcher, platform=getattr(scorer, "platform", "cpu"))
    ready_event.set()
    try:
        owner.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        owner.close()


def _worker_entry(
    sock_path: str,
    host: str,
    port: int,
    sr: int,
    request_timeout: float,
    ready_event,
) -> None:
    # the parent hid the cards (CUDA_VISIBLE_DEVICES=""): nothing here can
    # take a CUDA context on the single-tenant card
    from audioanalysisdetector_tpu_torch.serve.server import ScoreServer

    scorer = RemoteScorer(sock_path)
    server = ScoreServer(
        scorer, sr=sr, host=host, port=port, request_timeout=request_timeout, reuse_port=True
    )
    ready_event.set()
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.close()


@contextlib.contextmanager
def _cuda_hidden(hide: bool = True):
    """Processes started inside see no CUDA device (``spawn`` copies the
    environment at start)."""
    old = os.environ.get("CUDA_VISIBLE_DEVICES")
    if hide:
        os.environ["CUDA_VISIBLE_DEVICES"] = ""
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("CUDA_VISIBLE_DEVICES", None)
        else:
            os.environ["CUDA_VISIBLE_DEVICES"] = old


class MultiprocessServer:
    """Orchestrates the owner + N workers; the parent stays a supervisor.

    ``factory_spec`` names a top-level ``module:function`` returning
    ``(scorer, n_samples)``: it is resolved INSIDE the owner process, so
    the card is only ever used there (``spawn`` start method; CUDA cannot
    be forked). ``force_cpu`` hides the cards from the owner too: a factory
    that builds on a device is then handed ``device="cpu"`` in
    ``factory_kwargs`` by the caller, or fails.
    """

    def __init__(
        self,
        *,
        workers: int,
        sr: int,
        host: str = "127.0.0.1",
        port: int = 0,
        factory_spec: str = "audioanalysisdetector_tpu_torch.serve.multiproc:default_mel_factory",
        factory_kwargs: dict | None = None,
        batcher_kwargs: dict | None = None,
        request_timeout: float = 60.0,
        force_cpu: bool = False,
    ):
        if workers < 1:
            raise ValueError(f"workers must be >= 1, got {workers}")
        if not hasattr(socket, "SO_REUSEPORT"):
            raise RuntimeError("SO_REUSEPORT unavailable on this platform")
        self.workers = int(workers)
        self.sr = int(sr)
        self.host = host
        self.request_timeout = float(request_timeout)
        self._factory = (factory_spec, dict(factory_kwargs or {}))
        self._batcher_kwargs = dict(batcher_kwargs or {})
        self._force_cpu = bool(force_cpu)
        self._tmpdir = tempfile.mkdtemp(prefix="aad_serve_")
        self.sock_path = os.path.join(self._tmpdir, "device.sock")
        # resolve port 0 up front: every worker must bind the SAME concrete
        # port for the kernel to form a reuseport group. The probe socket
        # stays bound (never listening: a non-listening member receives no
        # TCP connections) so the port cannot be reallocated between now
        # and the workers' binds.
        self._probe = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._probe.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
        self._probe.bind((host, port))
        self.port = self._probe.getsockname()[1]
        self._procs: list = []

    @property
    def pids(self) -> dict:
        """``{"owner": pid, "workers": [pid, ...]}`` of the started processes."""
        return {"owner": self._procs[0].pid if self._procs else None,
                "workers": [p.pid for p in self._procs[1:]]}

    def start(self, ready_timeout: float = 600.0) -> None:
        """Spawn owner + workers; block until every process reports ready.

        ``ready_timeout`` covers the owner's model build, kernel load and
        bucket-ladder warm-up."""
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        events = [ctx.Event() for _ in range(1 + self.workers)]
        spec, kwargs = self._factory
        owner = ctx.Process(
            target=_owner_entry,
            args=(self.sock_path, spec, kwargs, self._batcher_kwargs, events[0]),
            name="aad-device-owner",
            daemon=True,
        )
        with _cuda_hidden(self._force_cpu):
            owner.start()
        self._procs.append(owner)
        deadline = time.monotonic() + ready_timeout

        def _await(ev, proc, what: str) -> None:
            # poll so a child that DIED during init (bad checkpoint, import
            # error) fails fast instead of burning the whole ready_timeout
            while not ev.wait(1.0):
                if not proc.is_alive():
                    self.close()
                    raise RuntimeError(f"{what} exited during startup (exitcode {proc.exitcode})")
                if time.monotonic() >= deadline:
                    self.close()
                    raise TimeoutError(f"{what} did not become ready")

        _await(events[0], owner, "device owner")
        with _cuda_hidden():
            for i in range(self.workers):
                w = ctx.Process(
                    target=_worker_entry,
                    args=(self.sock_path, self.host, self.port, self.sr, self.request_timeout, events[1 + i]),
                    name=f"aad-http-worker-{i}",
                    daemon=True,
                )
                w.start()
                self._procs.append(w)
        for i, ev in enumerate(events[1:]):
            _await(ev, self._procs[1 + i], f"HTTP worker {i}")

    def close(self) -> None:
        for p in self._procs:
            if p.is_alive():
                p.terminate()
        for p in self._procs:
            p.join(timeout=10.0)
            if p.is_alive():
                p.kill()
                p.join(timeout=10.0)
        self._procs.clear()
        self._probe.close()
        if os.path.exists(self.sock_path):
            os.unlink(self.sock_path)
        if os.path.isdir(self._tmpdir):
            try:
                os.rmdir(self._tmpdir)
            except OSError:
                pass

    def __enter__(self) -> "MultiprocessServer":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.close()
