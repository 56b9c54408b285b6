"""The port's multi-process serving and its multi-device splits, on the CPU.

Protocol tests run the owner and its client in-process (threads, no spawn)
to pin the framing and the error mapping, as the JAX package's
tests/test_serve_multiproc.py does; one test spawns the real topology (one
owner + 2 ``SO_REUSEPORT`` HTTP workers) with ``force_cpu``. Then
``build_mel_scorer(data_parallel=...)`` and ``_batch_sharding`` on one
device, where both keep the JAX package's single-device answers.
"""

import json
import os
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from audioanalysisdetector_tpu_torch.data.pipeline import _batch_sharding
from audioanalysisdetector_tpu_torch.ops import launch_counts
from audioanalysisdetector_tpu_torch.serve import BatchingScorer, MultiprocessServer, ServiceOverloaded
from audioanalysisdetector_tpu_torch.serve.multiproc import (
    DeviceOwner,
    RemoteScorer,
    _recv_frame,
    _send_frame,
    noop_scorer_factory,
    resolve_factory,
)
from audioanalysisdetector_tpu_torch.serve.server import build_mel_scorer

torch.set_num_threads(2)

N = 64  # row length for machinery tests


def make_sum_scorer():
    """Spawn-importable factory: scores are row sums (pure numpy)."""

    def scorer(batch):
        return batch.sum(axis=1)

    return scorer, N


def _owner_pair(scorer=None, **batcher_kwargs):
    scorer = scorer or make_sum_scorer()[0]
    batcher = BatchingScorer(scorer, n_samples=N, **{"max_batch": 8, "max_wait_ms": 5.0, **batcher_kwargs})
    sock_path = os.path.join(tempfile.mkdtemp(prefix="aad_mp_test_"), "dev.sock")
    owner = DeviceOwner(sock_path, batcher, platform="cpu")
    owner.start_background()
    return owner, sock_path


def test_frames_and_factories():
    a, b = __import__("socket").socketpair()
    try:
        _send_frame(a, 3, b"xyz")
        _send_frame(a, 0)
        assert _recv_frame(b) == (3, b"xyz")
        assert _recv_frame(b) == (0, b"")
        a.close()
        with pytest.raises(ConnectionError):
            _recv_frame(b)
    finally:
        b.close()
    assert resolve_factory("tests.test_torch_serve_multiproc:make_sum_scorer") is make_sum_scorer
    with pytest.raises(ValueError, match="module:function"):
        resolve_factory("tests.test_torch_serve_multiproc")
    scorer, n = noop_scorer_factory(16)
    assert n == 16 and scorer(np.ones((3, 16))).tolist() == [0.0] * 3


def test_remote_scorer_roundtrip_and_contract():
    owner, sock_path = _owner_pair()
    try:
        remote = RemoteScorer(sock_path, connect_timeout=10.0)
        assert remote.n_samples == N and remote.max_batch == 8
        assert remote.platform == "cpu"
        rows = np.random.default_rng(0).standard_normal((5, N)).astype(np.float32)
        np.testing.assert_allclose(remote.score(rows), rows.sum(axis=1), rtol=1e-5)
        # 1-D input promotes to one row, like BatchingScorer.score
        np.testing.assert_allclose(remote.score(rows[0]), rows[:1].sum(axis=1), rtol=1e-5)
        # the stats proxy reads the owner's GLOBAL counters and its launches
        snap = remote.stats.snapshot()
        assert snap["utterances"] == 6
        assert list(snap["kernel_launches"].items()) == [(name, 0) for name in launch_counts()]
        remote.close()
        with pytest.raises(RuntimeError):
            remote.score(rows)
    finally:
        owner.close()


def test_remote_scorer_error_mapping():
    owner, sock_path = _owner_pair()
    try:
        remote = RemoteScorer(sock_path, connect_timeout=10.0)
        with pytest.raises(ValueError):  # wrong row length, client-side
            remote.score(np.zeros((2, N + 1), np.float32))
        # a malformed frame is the owner's "bad request"
        sock = remote._conn()
        _send_frame(sock, 2, b"\x01\x00")
        assert _recv_frame(sock)[0] == 3
        _send_frame(sock, 9)
        assert _recv_frame(sock) == (3, b"unknown op 9")
        # owner-side shutdown surfaces as an internal error frame, and a
        # closed batcher refuses work rather than hanging the socket
        owner.batcher.close()
        with pytest.raises(RuntimeError):
            remote.score(np.zeros((1, N), np.float32))
    finally:
        owner.close()


def test_remote_scorer_overload_maps_to_service_overloaded():
    gate = threading.Event()

    def slow(batch):  # block dispatch so the queue can fill
        gate.wait(5.0)
        return batch.sum(axis=1)

    owner, sock_path = _owner_pair(slow, max_batch=2, max_wait_ms=1.0, queue_depth=1)
    try:
        remote = RemoteScorer(sock_path, connect_timeout=10.0)
        rows = np.zeros((2, N), np.float32)
        t1 = threading.Thread(target=lambda: remote.score(rows, timeout=10.0), daemon=True)
        t1.start()
        time.sleep(0.3)  # the worker picks up the first batch and blocks

        def flood():  # extra flooders may themselves see the 503: fine
            try:
                RemoteScorer(sock_path, connect_timeout=5.0).score(rows, timeout=10.0)
            except ServiceOverloaded:
                pass

        flooders = [threading.Thread(target=flood, daemon=True) for _ in range(2)]
        for t in flooders:
            t.start()
        time.sleep(0.3)  # the queue (depth 1) now holds a waiter
        with pytest.raises(ServiceOverloaded):
            RemoteScorer(sock_path, connect_timeout=5.0).score(rows, timeout=10.0)
    finally:
        gate.set()
        owner.close()


def test_multiprocess_server_end_to_end():
    """1 spawned device owner + 2 SO_REUSEPORT HTTP workers on one port."""
    env_before = os.environ.get("CUDA_VISIBLE_DEVICES")
    srv = MultiprocessServer(
        workers=2,
        sr=16000,
        factory_spec="tests.test_torch_serve_multiproc:make_sum_scorer",
        batcher_kwargs=dict(max_batch=8, max_wait_ms=5.0),
        force_cpu=True,
    )
    try:
        srv.start(ready_timeout=120.0)
        assert len(srv.pids["workers"]) == 2 and srv.pids["owner"] is not None
        url = f"http://127.0.0.1:{srv.port}"
        h = json.loads(urllib.request.urlopen(url + "/healthz", timeout=30).read())
        assert h["ok"] and h["n_samples"] == N and h["platform"] == "cpu"

        rows = np.random.default_rng(0).standard_normal((4, N)).astype(np.float32)
        req = urllib.request.Request(
            url + "/v1/score_raw", data=rows.tobytes(),
            headers={"Content-Type": "application/octet-stream", "X-Rows": "4"},
        )
        out = json.loads(urllib.request.urlopen(req, timeout=60).read())
        np.testing.assert_allclose(out["scores"], rows.sum(axis=1), rtol=1e-5)

        # each request opens a fresh connection, so the kernel spreads them
        # over the reuseport group; stats must still aggregate globally
        for i in range(6):
            req = urllib.request.Request(
                url + "/v1/score", data=json.dumps({"pcm": rows[i % 4].tolist()}).encode(),
                headers={"Content-Type": "application/json"},
            )
            json.loads(urllib.request.urlopen(req, timeout=60).read())
        stats = json.loads(urllib.request.urlopen(url + "/v1/stats", timeout=30).read())
        assert stats["utterances"] == 10  # 4 + 6 across both workers

        # malformed request -> 400 from whichever worker catches it
        bad = urllib.request.Request(
            url + "/v1/score_raw", data=b"\x00" * 10,  # not a float32 multiple
            headers={"Content-Type": "application/octet-stream"},
        )
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(bad, timeout=30)
        assert ei.value.code == 400
    finally:
        procs = list(srv._procs)
        srv.close()
    assert procs and not any(p.is_alive() for p in procs)
    assert os.environ.get("CUDA_VISIBLE_DEVICES") == env_before  # hidden only for the children


def test_mel_scorer_data_parallel_on_one_device():
    """One device: ``data_parallel=True`` raises the JAX package's error,
    auto and False build the one-device scorer (``row_multiple`` 1)."""
    kw = dict(sr=8000, seconds=0.25, n_mels=16, mel_profile="speech", device="cpu")
    with pytest.raises(ValueError, match="data_parallel=True but only one local device"):
        build_mel_scorer(data_parallel=True, **kw)
    wav = np.random.default_rng(0).standard_normal((3, 2000)).astype(np.float32)
    auto, n = build_mel_scorer(data_parallel=None, **kw)
    off, _ = build_mel_scorer(data_parallel=False, **kw)
    assert n == 2000 and auto.row_multiple == off.row_multiple == 1
    np.testing.assert_array_equal(auto(wav), off(wav))


def test_batch_sharding_single_device():
    """None on one device, whatever the batch (the JAX package shards only
    over more than one: tests/test_data.py:148-157)."""
    for batch in (8, 6, 1):
        assert _batch_sharding(batch, "cpu") is None
        assert _batch_sharding(batch, "cuda") is None  # no card visible here
