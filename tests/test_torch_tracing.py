"""The port's spans and serving counters, on the CPU.

``utils.profiling.span`` is a ``record_function`` range with a reading
while a profiler records and the one shared no-op context otherwise; here,
where CUDA is not initialized, a reading is the host clock's, summed by name
in ``span_readings()``. The scorers, the mel pad, the serving batcher and
``fit`` open their spans where the work happens; ``ServeStats`` sums queue
wait, dispatch and parse time on the host clock and ``GET /v1/stats``
returns them.
"""

import dataclasses
import json
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch
import torch.autograd.profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

from audioanalysisdetector_tpu_torch.frontend.cqcc import CQCCConfig
from audioanalysisdetector_tpu_torch.frontend.mel import MelConfig
from audioanalysisdetector_tpu_torch.models.aasist import SSLAASIST
from audioanalysisdetector_tpu_torch.models.bilstm_classifier import BiLSTMClassifier
from audioanalysisdetector_tpu_torch.models.cnn_bilstm import CNNBiLSTMHybrid
from audioanalysisdetector_tpu_torch.models.gmm import DiagGMM
from audioanalysisdetector_tpu_torch.models.mhfa import W2VBertMHFA, WavLMMHFA
from audioanalysisdetector_tpu_torch.models.w2v_bert import W2V_BERT_2
from audioanalysisdetector_tpu_torch.models.wav2vec2 import WAVLM_LARGE, XLSRConfig
from audioanalysisdetector_tpu_torch.ops.ct_mel import ct_mel_unpadded
from audioanalysisdetector_tpu_torch.ops.wave_mel import wave_mel_unpadded
from audioanalysisdetector_tpu_torch.score.e2e import (
    make_cqcc_fused_scorer,
    make_mel_cnn_bilstm_scorer,
    make_w2vbert_mhfa_scorer,
    make_wavlm_mhfa_scorer,
    make_xlsr_aasist_scorer,
)
from audioanalysisdetector_tpu_torch.serve.server import BatchingScorer, ScoreServer
from audioanalysisdetector_tpu_torch.train import loop
from audioanalysisdetector_tpu_torch.train.optimizers import make_optimizer
from audioanalysisdetector_tpu_torch.train.state import TrainState
from audioanalysisdetector_tpu_torch.utils import device_trace, span
from audioanalysisdetector_tpu_torch.utils.profiling import reset_span_readings, span_readings

torch.set_num_threads(2)
N = 160  # samples a row in the serving tests


def _spans(prof) -> list[tuple[str, int, int, int]]:
    """``(name, start_ns, end_ns, thread)`` of every span the profiler kept."""
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(), e.start_thread_id())
            for e in prof.profiler.kineto_results.events()
            if e.is_user_annotation() and e.device_type() == torch.autograd.DeviceType.CPU]


def _named(spans, name):
    return [s for s in spans if s[0] == name]


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2] and inner[3] == outer[3]


def _wav(rows: int, n: int = 32000, seed: int = 0) -> torch.Tensor:
    return torch.from_numpy((np.random.default_rng(seed).standard_normal((rows, n)) * 0.1).astype(np.float32))


def _mel_scorer():
    cfg = MelConfig.for_profile("parity")
    return make_mel_cnn_bilstm_scorer(CNNBiLSTMHybrid(1 + 32000 // cfg.hop_length), cfg)


def _fused_scorer():
    torch.manual_seed(0)
    k, d = 4, 19
    gmm = lambda shift: DiagGMM(torch.full((k,), 1.0 / k), torch.randn(k, d) + shift, torch.ones(k, d))  # noqa: E731
    return make_cqcc_fused_scorer(BiLSTMClassifier(hidden=8), gmm(0.0), gmm(0.5), CQCCConfig())


def test_span_off_is_the_shared_noop():
    assert not autograd_profiler._is_profiler_enabled
    off = span("off.span")
    assert off is span("another.span")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with off:
            torch.randn(8) + 1
        with span("on.span"):
            torch.randn(8) + 1
    assert [s[0] for s in _spans(prof)] == ["on.span"]


def test_readings_only_while_a_profiler_records():
    reset_span_readings()
    with span("off.span"):
        torch.randn(8) + 1
    assert span("off.span") is span("another.span")  # the shared no-op, no reading
    assert span_readings() == {}
    with profile(activities=[ProfilerActivity.CPU]):
        with span("on.span"):
            torch.randn(8) + 1
    with span("on.span"):  # the profiler has stopped
        torch.randn(8) + 1
    assert list(span_readings()) == ["on.span"] and span_readings()["on.span"][1] == 1


def test_readings_sum_by_name_with_nested_spans_and_reset():
    reset_span_readings()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            with span("outer"):
                with span("inner"):
                    time.sleep(0.005)
                with span("inner"):
                    time.sleep(0.005)
    readings = span_readings()
    (outer_ms, outer_n), (inner_ms, inner_n) = readings["outer"], readings["inner"]
    assert set(readings) == {"outer", "inner"} and (outer_n, inner_n) == (3, 6)
    assert inner_ms >= 6 * 5.0  # the host clock: CUDA is not initialized here
    assert outer_ms >= inner_ms  # the nested spans are inside the outer's reading
    assert span_readings() == readings  # reading changes nothing
    reset_span_readings()
    assert span_readings() == {}


def test_two_threads_spans_land_in_one_set_of_readings():
    reset_span_readings()
    barrier = threading.Barrier(2, timeout=30)

    def work():
        barrier.wait()
        for _ in range(200):
            with span("threaded.span"):
                pass

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            threads = [threading.Thread(target=work) for _ in range(2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert span_readings()["threaded.span"][1] == 400


def test_device_trace_resets_the_readings(tmp_path):
    reset_span_readings()
    with profile(activities=[ProfilerActivity.CPU]):
        with span("before.trace"):
            torch.randn(8) + 1
    assert "before.trace" in span_readings()
    with device_trace(str(tmp_path / "trace")):
        with span("in.trace"):
            torch.randn(8) + 1
    assert {name: n for name, (_, n) in span_readings().items()} == {"in.trace": 1}


def _wavlm_scorer():
    torch.manual_seed(0)
    cfg = dataclasses.replace(WAVLM_LARGE, conv_dim=16, hidden=32, heads=2, ffn=64, layers=2, pos_kernel=8,
                              pos_groups=2, rel_buckets=16, rel_max_distance=20)
    return make_wavlm_mhfa_scorer(WavLMMHFA(cfg, heads=4, compression=8, outputs=8))


def _w2vbert_scorer():
    torch.manual_seed(0)
    cfg = dataclasses.replace(W2V_BERT_2, hidden=32, heads=2, ffn=64, layers=2)
    return make_w2vbert_mhfa_scorer(W2VBertMHFA(cfg, heads=4, compression=8, outputs=8))


def _xlsr_scorer():
    torch.manual_seed(0)
    cfg = XLSRConfig(conv_dim=16, hidden=32, heads=2, ffn=64, layers=2, pos_kernel=8, pos_groups=2)
    return make_xlsr_aasist_scorer(SSLAASIST(cfg))


REMOVED = ["lstm.last_only", "gmm.kernel"]  # spans the port no longer opens


@pytest.mark.parametrize(
    "make,inner,absent,wav_len",
    [(_mel_scorer, {"score.model": {"lstm.layer": 1}}, ["ssl.attend"], 32000),
     (_fused_scorer, {"score.model": {"fused.gmm": 1, "lstm.layer": 2}}, ["ssl.attend"], 32000),
     (_wavlm_scorer, {"score.model": {"mhfa.pool": 1}, "score.frontend": {"ssl.attend": 2}},
      ["lstm.layer", "fused.gmm"], 32000),
     (_w2vbert_scorer, {"score.model": {"mhfa.pool": 1}, "score.frontend": {"ssl.attend": 2}},
      ["lstm.layer", "fused.gmm", "wavlm.gated_bias"], 32000),
     (_xlsr_scorer, {"score.model": {"aasist.graph": 1}, "score.frontend": {"ssl.attend": 2}},
      ["lstm.layer", "fused.gmm", "mhfa.pool"], 16000)],
    ids=["mel", "fused", "wavlm", "w2vbert", "xlsr"],
)
def test_scorer_spans_nest(make, inner, absent, wav_len):
    """``inner``: the spans each call opens inside ``score.model`` or
    ``score.frontend``, with their number a call (``ssl.attend`` once a
    layer: two in these tiny encoders, 24 at the published depth)."""
    score = make()
    wav = _wav(2, wav_len)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            score(wav)
    assert not autograd_profiler._is_profiler_enabled
    assert isinstance(span("after"), type(span("off")))  # the no-op again
    spans = _spans(prof)
    calls = _named(spans, "score.call")
    assert len(calls) == 2
    for name in ["score.frontend", "score.model"]:
        found = _named(spans, name)
        assert len(found) == 2 and all(any(_inside(s, c) for c in calls) for s in found), name
    for outer, counts in inner.items():
        for name, per_call in counts.items():
            found = _named(spans, name)
            assert len(found) == 2 * per_call, name
            assert all(any(_inside(s, o) for o in _named(spans, outer)) for s in found), name
    for name in absent + REMOVED:
        assert not _named(spans, name), name
    front, model = _named(spans, "score.frontend"), _named(spans, "score.model")
    assert all(f[2] <= m[1] for f, m in zip(front, model))  # frontend, then model


@pytest.mark.parametrize("unpadded", [ct_mel_unpadded, wave_mel_unpadded], ids=["ct_mel", "wave_mel"])
def test_mel_pad_span(unpadded):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        unpadded(_wav(2, 8000), MelConfig.for_profile("parity"))
    assert len(_named(_spans(prof), "mel.pad")) == 1


@pytest.mark.parametrize("all_threads", [True, False])
def test_worker_thread_span_needs_all_threads(all_threads):
    def work():
        with span("worker.span"):
            torch.randn(8) * 2

    kw = {"experimental_config": torch._C._profiler._ExperimentalConfig(profile_all_threads=True)} if all_threads else {}
    with profile(activities=[ProfilerActivity.CPU], **kw) as prof:
        with span("main.span"):
            t = threading.Thread(target=work)
            t.start()
            t.join()
    spans = _spans(prof)
    assert len(_named(spans, "main.span")) == 1
    worker = _named(spans, "worker.span")
    assert len(worker) == (1 if all_threads else 0)
    if all_threads:
        assert worker[0][3] != _named(spans, "main.span")[0][3]


def _row_sums(wav: np.ndarray) -> np.ndarray:
    return np.asarray(wav, dtype=np.float32).sum(axis=1)


def test_batcher_counts_queue_wait_and_dispatch():
    batcher = BatchingScorer(_row_sums, n_samples=N, max_batch=8, max_wait_ms=5.0, adaptive=False)
    try:
        rows = np.random.default_rng(1).standard_normal((12, N)).astype(np.float32)
        got = [None] * len(rows)

        def ask(i):
            got[i] = batcher.score(rows[i:i + 1])

        threads = [threading.Thread(target=ask, args=(i,)) for i in range(len(rows))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        np.testing.assert_allclose(np.concatenate(got), _row_sums(rows), rtol=1e-6)
        s = batcher.stats.snapshot()
    finally:
        batcher.close()
    assert s["batches"] >= 1 and s["popped"] == len(rows) and s["requests"] == len(rows)
    assert s["queue_wait_s"] > 0 and s["dispatch_s"] > 0
    assert s["parse_s"] == 0 and s["parsed"] == 0  # no HTTP front end


def _post(url: str, body: bytes) -> dict:
    req = urllib.request.Request(url, data=body, headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())


def test_stats_endpoint_and_serving_spans(tmp_path):
    batcher = BatchingScorer(_row_sums, n_samples=N, max_batch=8, max_wait_ms=2.0)
    server = ScoreServer(batcher, sr=16000, port=0)
    server.start_background()
    try:
        base = f"http://127.0.0.1:{server.port}"
        rows = np.random.default_rng(2).standard_normal((3, N)).astype(np.float32)
        with device_trace(str(tmp_path / "trace")):
            for r in rows:
                out = _post(f"{base}/v1/score", json.dumps({"pcm": [r.tolist()]}).encode())
                assert out["scores"] == pytest.approx([float(_row_sums(r[None])[0])], rel=1e-5)
        with urllib.request.urlopen(f"{base}/v1/stats", timeout=60) as resp:
            stats = json.loads(resp.read())
    finally:
        server.close()
        batcher.close()
    assert stats["parsed"] == 3 and stats["parse_s"] > 0
    assert stats["popped"] == 3 and stats["queue_wait_s"] > 0 and stats["dispatch_s"] > 0
    (trace,) = (tmp_path / "trace").glob("trace_*.json")
    events = json.loads(trace.read_text())["traceEvents"]
    tids = {name: {e["tid"] for e in events if e.get("name") == name}
            for name in ("serve.collect", "serve.dispatch", "serve.parse")}
    assert all(tids.values()), tids  # every thread of the service is in the trace
    assert tids["serve.collect"] == tids["serve.dispatch"]  # the batcher's thread
    assert not tids["serve.parse"] & tids["serve.dispatch"]  # the HTTP handlers'


def test_fit_spans(tmp_path):
    t, f, n_train, n_val, batch = 9, 16, 30, 11, 8
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((n_train + n_val, f, t)) * 10 - 40).astype(np.float32)
    y = rng.integers(0, 2, n_train + n_val)
    torch.manual_seed(0)
    state = TrainState.create(model=CNNBiLSTMHybrid(t, logits=True, dropout_rate=0.0, conv_dropout=0.0),
                              tx=make_optimizer("Adam", 1e-3))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        loop.fit(state, (x[:n_train], y[:n_train]), (x[n_train:], y[n_train:]), num_epochs=2, batch_size=batch,
                 loss_name="BCELoss", binary_head=True, run_dir=str(tmp_path / "run"), plots=False)
    spans = _spans(prof)
    epochs = _named(spans, "fit.epoch")
    assert len(epochs) == 2
    assert len(_named(spans, "fit.step")) == 2 * -(-n_train // batch)  # one a batch, the tail padded
    assert len(_named(spans, "fit.validate")) == 2
    checkpoints = _named(spans, "fit.checkpoint")
    assert len(checkpoints) in (2, 3)  # epoch 0 writes best and worst; epoch 1 one of them at most
    for name in ("fit.step", "fit.validate", "fit.checkpoint"):
        assert all(any(_inside(s, e) for e in epochs) for s in _named(spans, name)), name
    assert (tmp_path / "run" / "best_model.msgpack").is_file()
