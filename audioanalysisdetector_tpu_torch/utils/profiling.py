"""Tracing / profiling subsystem (PyTorch port).

Counterpart of the JAX package's ``utils/profiling.py``: per-step timing
aggregation with percentile summaries and throughput (``StepTimer``),
device trace capture (``device_trace``, ``torch.profiler`` writing a
Chrome trace that Perfetto or ``chrome://tracing`` opens), and the port's
one span primitive, ``span``. Work queued on a card runs asynchronously,
so the timers synchronize on the device of the result before the clock
stops.

``span(name)`` opens a ``torch.profiler.record_function`` range while a
profiler session records, so the span lies on the profiler's host clock
beside the kernels it launches; otherwise it is one shared no-op context
and costs one flag check. Spans are on exactly while a profiler records:
the benchmark's traced window, or an operator's ``device_trace``.

While a profiler records, each span also takes a reading. On open and on
close it records a timing event (``torch.cuda.Event``, from a reused pool)
on the current stream of the current device; closed pairs that the stream
has reached are folded into per-name totals by the non-blocking
``Event.query``, so nothing in the hot loop waits and memory stays bounded
over a long trace. A reading is the time between the stream reaching the
open stamp and reaching the close stamp, nested spans included: where the
card is busy and runs one stream (the offline cells) that is the span's
device time; for a host-only span on an idle stream it is about the span's
wall time. No stamp is taken while the stream captures a CUDA graph.
Where CUDA is not initialized the reading is the host clock's
(``time.perf_counter``). ``span_readings()`` waits for the devices that
hold stamps not yet reached and returns ``{name: (ms, completions)}``
since the last ``reset_span_readings()``; ``device_trace`` resets on entry.
An operator reads one trace's device time by span so::

    with device_trace("traces/"):
        score(batch)
    readings = span_readings()  # {"score.model": (ms, calls), ...}

Every span the port opens, and what reads it. The benchmark's ``span.*``
metrics (``portbench/metrics/span.*.py``, through
``portbench/metrics/_span.py``) read ``span_readings()`` after a traced
window and divide by the completed ``score.call`` spans;
``portbench/harness/spans.py`` puts each device operation of a kineto
trace under the spans open on its launching thread and names the card's
idle gaps by span path (``portbench/tools/span_readings.py``):

- ``score.call``: one call of a scorer of ``score/e2e.py``; its
  completions divide every ``span.*`` metric, and its device operations
  are the launches a call.
- ``score.frontend``: the scorer's features (log-mel; CQCC, transpose and
  scale; XLS-R; WavLM's or w2v-BERT's 25 hidden states; Whisper's 33):
  ``span.frontend_ms.score``.
- ``score.model``: the scorer's model (CNN-BiLSTM; ``fused_scores``;
  AASIST; MHFA): ``span.model_ms.score``.
- ``xlsr.features``, ``xlsr.encoder``: SSL-AASIST's frontend in two
  (the conv feature encoder and projection; the positional conv, the 24
  transformer layers and the final LayerNorm), inside ``score.frontend``:
  each half's device ms a call (``harness/spans.py::per_call``).
- ``wavlm.features``, ``wavlm.encoder``: WavLM-MHFA's frontend in two
  (the waveform's normalisation, the conv feature encoder and projection;
  the positional conv, the 24 gated layers and the final LayerNorm),
  inside ``score.frontend``: each half's device ms a call
  (``harness/spans.py::per_call``).
- ``wavlm.position_bias``: the bucket table (built once per T and device)
  gathered into the ``(H, T, T)`` position bias, once a call inside
  ``wavlm.encoder``; with ``wavlm.gated_bias``:
  ``span.wavlm_bias_ms.score``.
- ``wavlm.gated_bias``: one layer's gate and its product with the
  position bias (``models/wav2vec2.py::GatedEncoderLayer``), 24 a call
  inside ``wavlm.encoder``: ``span.wavlm_bias_ms.score``.
- ``ssl.attend``: ``models/wav2vec2.py::attend``, the SDPA call of the
  three SSL front ends and of Whisper's encoder (torch's copy of a float
  mask into 800-long rows, its fills, the attention kernel, the merge
  transpose), 24 a call (32 in Whisper's) inside ``score.frontend``:
  ``span.attention_ms.score``.
- ``w2vbert.fbank``, ``w2vbert.encoder``: w2v-BERT-MHFA's frontend in two
  (the Kaldi filterbank, ``frontend/fbank.py``; the projection and the 24
  Conformer layers), inside ``score.frontend``: each half's device ms a
  call (``harness/spans.py::per_call``).
- ``w2vbert.rel_key``: one layer's relative-key mask, ``q E^T``, its
  gather by the relative index and the scale
  (``models/w2v_bert.py::ConformerLayer.relative_key``), 24 a call inside
  ``w2vbert.encoder``: ``span.w2vbert_relkey_ms.score``.
- ``w2vbert.conv_module``: one layer's convolution module (pointwise, GLU,
  causal depthwise conv, LayerNorm, swish, pointwise;
  ``models/w2v_bert.py::ConvModule``), 24 a call inside
  ``w2vbert.encoder``: ``span.w2vbert_conv_ms.score``.
- ``whisper.log_mel``, ``whisper.encoder``: Whisper-MHFA's frontend in
  two (the center pad, K1 and the log-mel's normalisation,
  ``frontend/mel.py::whisper_log_mel``; the conv stem, the positions and
  the 32 layers), inside ``score.frontend``, once a call:
  ``whisper.logmel_ms.score`` reads the first.
- ``whisper.conv_stem``: the two convs of Whisper's stem with their GELUs
  (``models/whisper.py::WhisperEncoder.conv_stem``), once a call inside
  ``whisper.encoder``: ``whisper.stem_ms.score``. Voxtral's scorer opens
  ``whisper.log_mel`` (the whole clips' log-mel cut into windows),
  ``whisper.encoder`` (all the windows of a call in one batch),
  ``whisper.conv_stem`` and ``ssl.attend`` as Whisper-MHFA's does.
- ``voxtral.projector``, ``voxtral.decoder``, ``voxtral.head``: Voxtral's
  projector, its 30 decoder layers and its last-position head
  (``models/voxtral.py``), once a call inside ``score.model``:
  ``voxtral.decoder_ms.score`` reads the decoder.
- ``lm.attend``: ``models/voxtral.py::lm_attend``, one decoder layer's
  causal grouped-query attention (on the card K8's split of q, k and v
  and its launch; elsewhere the K/V expansion to the query heads, SDPA,
  the merge transpose), 30 a call inside ``voxtral.decoder``:
  ``voxtral.lm_attention_roofline``.
- ``mhfa.pool``: MHFA's layer mixes, compressions and attentive pooling
  (``models/mhfa.py``), inside ``score.model``: the pooling's device ms a
  call (``harness/spans.py::per_call``).
- ``aasist.graph``: AASIST from its node sets to the readout (graph
  attention, pools, both branches), inside ``score.model``: the graph
  layers' device ms a call (``harness/spans.py::per_call``).
- ``mel.pad``: the center pad before K1 (``ops/wave_mel.py``), and before
  K3 where it is given padded rows (``ops/ct_mel.py``: a CPU tensor, or a
  pad mode other than reflect; on the card K3 folds the reflect pad into
  its frame addressing and opens none): the pad's device ms a call
  (``harness/spans.py::per_call``).
- ``fused.gmm``: the GMM arm's masked LLR (``score/fused.py``; on the card
  one K6 launch, elsewhere ``masked_llr``): the GMMs' device ms a call
  (``harness/spans.py::per_call``; ``k6_roofline`` reads K6 itself).
- ``lstm.layer``: one ``models/lstm.py::BiLSTM`` call on every route (K4's
  full scan with its input products, ``last_only``, cuDNN): two a fused
  scorer call and one a mel scorer call, inside ``score.model``:
  ``span.lstm_ms.score``.
- ``lstm.scan``: one launch of K4, the inference LSTM recurrence
  (``ops/lstm_scan.py``): two a fused scorer call and one a mel scorer
  call (its hidden-32 kernel), each inside ``lstm.layer``, and none where
  a backward is asked: the recurrence's device ms a call
  (``harness/spans.py::per_call``).
- ``cqcc.kernel``: one launch of K5, the CQCC of raw waveforms
  (``ops/cqcc.py``, routed by ``frontend/cqcc.py::cqcc``): one a fused
  scorer call on the card inside ``score.frontend``, none on the CPU, in
  the mel scorer or where a backward is asked: ``span.cqcc_ms.score``.
- ``serve.collect``: ``BatchingScorer`` gathering one dispatch after its
  first slice arrived, on the batcher's thread: the host gaps of a
  serving trace.
- ``serve.dispatch``: the scorer call of one dispatch (upload, score,
  fetch): the device time of a serving trace by dispatch.
- ``serve.parse``: ``ScoreServer`` turning one request body into rows
  (JSON, base64, ``audio_b64`` decode): the host gaps of a serving trace.
- ``fit.epoch``, ``fit.step`` (one ``step`` call), ``fit.validate`` (the
  validation loop and the epoch's one host sync) and ``fit.checkpoint``
  (a best or worst checkpoint written): the share of a training window
  under validation and checkpoints, and the gaps of a training trace.

The serving counters that are always on (``queue_wait_s``, ``popped``,
``dispatch_s``, ``parse_s``, ``parsed``) are ``serve/server.py::ServeStats``'s,
read at ``GET /v1/stats``.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler

_OFF = contextlib.nullcontext()


def span(name: str):
    """``with span("score.frontend"): ...``: a ``record_function`` range
    named ``name`` with its reading while a profiler session records, else
    the shared no-op context. Names and readers: the module docstring."""
    if _autograd_profiler._is_profiler_enabled:
        return _Recorded(name)
    return _OFF


_readings_lock = threading.Lock()  # spans close on serving threads while another reads
_totals: dict[str, list] = {}  # name -> [ms, completions]
_pending: deque = deque()  # (name, device, open event, close event), in the order the spans closed
_pool: dict[int, list] = {}  # device -> timing events free for reuse


def _event(device: int) -> torch.cuda.Event:
    with _readings_lock:
        free = _pool.get(device)
        if free:
            return free.pop()
    return torch.cuda.Event(enable_timing=True)


def _stamp():
    """What a reading starts from: the host clock where CUDA is not
    initialized, else a timing event recorded on the current stream of the
    current device (None while that stream captures a CUDA graph)."""
    if not torch.cuda.is_initialized():
        return time.perf_counter()
    if torch.cuda.is_current_stream_capturing():
        return None
    device = torch.cuda.current_device()
    event = _event(device)
    event.record(torch.cuda.current_stream(device))
    return device, event


def _add(name: str, ms: float) -> None:
    total = _totals.setdefault(name, [0.0, 0])
    total[0] += ms
    total[1] += 1


def _fold() -> None:
    """Fold the completed stamp pairs at the head of ``_pending`` into the
    totals and free their events; ``query`` never waits. Under the lock."""
    while _pending:
        name, device, start, end = _pending[0]
        if not (end.query() and start.query()):
            return
        _pending.popleft()
        _add(name, start.elapsed_time(end))
        _pool.setdefault(device, []).extend((start, end))


class _Recorded:
    """A span while a profiler records: the ``record_function`` range and,
    inside it, the stamps its reading is taken between."""

    __slots__ = ("name", "_range", "_opened")

    def __init__(self, name: str):
        self.name = name
        self._range = torch.profiler.record_function(name)

    def __enter__(self):
        self._range.__enter__()
        self._opened = _stamp()
        return self

    def __exit__(self, *exc):
        opened, name = self._opened, self.name
        if isinstance(opened, float):
            ms = (time.perf_counter() - opened) * 1e3
            with _readings_lock:
                _add(name, ms)
        elif opened is not None and not torch.cuda.is_current_stream_capturing():
            device, start = opened
            end = _event(device)
            end.record(torch.cuda.current_stream(device))
            with _readings_lock:
                _pending.append((name, device, start, end))
                _fold()
        return self._range.__exit__(*exc)


def span_readings() -> dict[str, tuple[float, int]]:
    """``{name: (ms, completions)}`` of the spans closed since the last
    ``reset_span_readings``, summed by name: first waits for the devices
    that hold stamps not yet reached."""
    with _readings_lock:
        devices = {device for _, device, _, _ in _pending}
    for device in devices:
        torch.cuda.synchronize(device)
    with _readings_lock:
        _fold()
        return {name: (ms, n) for name, (ms, n) in _totals.items()}


def reset_span_readings() -> None:
    """Forget every reading, and the stamps not yet reached."""
    with _readings_lock:
        _totals.clear()
        _pending.clear()


def _first_tensor(x) -> torch.Tensor | None:
    """The first tensor in ``x`` (a tensor, or nested lists / tuples / dicts)."""
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        for item in x:
            t = _first_tensor(item)
            if t is not None:
                return t
    return None


def sync_on(x) -> None:
    """Wait for the card that holds ``x``'s first tensor (a no-op on the CPU)."""
    t = _first_tensor(x)
    if t is not None and t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


@dataclass
class StepTimer:
    """Accumulates per-step wall times.

    ``measure`` synchronizes on whatever the body passes to ``sync`` before
    the clock stops; without it, card work would be timed at launch cost only.
    """

    name: str = "step"
    times: list[float] = field(default_factory=list)

    @contextlib.contextmanager
    def measure(self):
        """Usage: ``with timer.measure() as sync: out = sync(step(...))``.

        ``sync`` waits for the device of its argument's first tensor (and
        returns the argument), so the device work is inside the span.
        """

        def sync(x):
            sync_on(x)
            return x

        t0 = time.perf_counter()
        yield sync
        self.times.append(time.perf_counter() - t0)

    def record(self, seconds: float) -> None:
        self.times.append(seconds)

    def summary(self, *, items_per_step: int | None = None, skip_warmup: int = 1) -> dict:
        t = np.asarray(self.times[skip_warmup:] or self.times)
        out = {
            "name": self.name,
            "steps": len(t),
            "mean_ms": float(t.mean() * 1e3),
            "p50_ms": float(np.percentile(t, 50) * 1e3),
            "p99_ms": float(np.percentile(t, 99) * 1e3),
            "total_s": float(t.sum()),
        }
        if items_per_step:
            out["items_per_sec"] = float(items_per_step / t.mean())
        return out

    def dump(self, path: str, **kwargs) -> None:
        with open(path, "w") as f:
            json.dump(self.summary(**kwargs), f, indent=2)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the CPU and, where there is a
    card, of CUDA, from every thread of the process (a serving trace holds
    the batcher's thread and the HTTP handlers'), with the port's spans;
    on exit it is written into ``log_dir`` as a Chrome trace
    (``trace_<pid>_<ns>.json``). The span readings are reset on entry, so
    ``span_readings()`` after it holds this trace's."""
    reset_span_readings()
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(
        activities=activities,
        experimental_config=torch._C._profiler._ExperimentalConfig(profile_all_threads=True),
    )
    prof.__enter__()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
