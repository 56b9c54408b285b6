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
the benchmark's traced window, or an operator's ``device_trace``. Every
span the port opens, and what reads it (``portbench/harness/spans.py``
puts each device operation under the spans open on its launching thread
and names the card's idle gaps by span path;
``portbench/tools/span_readings.py`` reports the per-call readings):

- ``score.call``: one call of a scorer of ``score/e2e.py``; the calls
  completed in a window divide every per-call reading, and its device
  operations are the launches a call.
- ``score.frontend``: the scorer's features (log-mel; CQCC, transpose and
  scale; XLS-R; WavLM's or w2v-BERT's 25 hidden states): the frontend's
  device ms a call.
- ``score.model``: the scorer's model (CNN-BiLSTM; ``fused_scores``;
  AASIST; MHFA): the model's device ms a call.
- ``xlsr.features``, ``xlsr.encoder``: SSL-AASIST's frontend in two
  (the conv feature encoder and projection; the positional conv, the 24
  transformer layers and the final LayerNorm), inside ``score.frontend``:
  each half's device ms a call.
- ``wavlm.features``, ``wavlm.encoder``: WavLM-MHFA's frontend in two
  (the waveform's normalisation, the conv feature encoder and projection;
  the positional conv, the 24 gated layers and the final LayerNorm),
  inside ``score.frontend``: each half's device ms a call.
- ``wavlm.position_bias``: the bucket table (built once per T and device)
  gathered into the ``(H, T, T)`` position bias, once a call inside
  ``wavlm.encoder``: its device ms a call.
- ``wavlm.gated_bias``: one layer's gate and its product with the
  position bias (``models/wav2vec2.py::GatedEncoderLayer``), 24 a call
  inside ``wavlm.encoder``: the gated bias's device ms a call (planned
  ``span.wavlm_bias_ms.score``).
- ``w2vbert.fbank``, ``w2vbert.encoder``: w2v-BERT-MHFA's frontend in two
  (the Kaldi filterbank, ``frontend/fbank.py``; the projection and the 24
  Conformer layers), inside ``score.frontend``: each half's device ms a
  call.
- ``w2vbert.rel_key``: one layer's relative-key mask, ``q E^T``, its
  gather by the relative index and the scale
  (``models/w2v_bert.py::ConformerLayer.relative_key``), 24 a call inside
  ``w2vbert.encoder``: the mask's device ms a call (planned
  ``span.w2vbert_relkey_ms.score``).
- ``w2vbert.conv_module``: one layer's convolution module (pointwise, GLU,
  causal depthwise conv, LayerNorm, swish, pointwise;
  ``models/w2v_bert.py::ConvModule``), 24 a call inside
  ``w2vbert.encoder``: the module's device ms a call (planned
  ``span.w2vbert_conv_ms.score``).
- ``mhfa.pool``: MHFA's layer mixes, compressions and attentive pooling
  (``models/mhfa.py``), inside ``score.model``: the pooling's device ms a
  call.
- ``aasist.graph``: AASIST from its node sets to the readout (graph
  attention, pools, both branches), inside ``score.model``: the graph
  layers' device ms a call.
- ``mel.pad``: the center pad before K1 (``ops/wave_mel.py``), and before
  K3 where it is given padded rows (``ops/ct_mel.py``: a CPU tensor, or a
  pad mode other than reflect; on the card K3 folds the reflect pad into
  its frame addressing and opens none): the pad's device ms a call.
- ``fused.gmm``: the GMM arm's masked LLR (``score/fused.py``): the GMMs'
  device ms a call.
- ``lstm.last_only``: ``models/lstm.py::BiLSTM`` computing position T-1
  alone (the forward scan and one backward cell step): the second BiLSTM of
  ``BiLSTMClassifier``, one a fused scorer call inside ``score.model``, none
  in the mel scorer: that layer's device ms a call.
- ``lstm.scan``: one launch of K4, the inference LSTM recurrence
  (``ops/lstm_scan.py``): two a fused scorer call inside ``score.model``
  (the first BiLSTM's two directions; the second's forward scan, inside
  ``lstm.last_only``), none in the mel scorer (hidden 32 keeps cuDNN) and
  none where a backward is asked: the recurrence's device ms a call.
- ``cqcc.kernel``: one launch of K5, the CQCC of raw waveforms
  (``ops/cqcc.py``, routed by ``frontend/cqcc.py::cqcc``): one a fused
  scorer call on the card inside ``score.frontend``, none on the CPU, in
  the mel scorer or where a backward is asked: the CQCC's device ms a call.
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
import time
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler

_OFF = contextlib.nullcontext()


def span(name: str):
    """``with span("score.frontend"): ...``: a ``record_function`` range
    named ``name`` while a profiler session records, else the shared no-op
    context. Names and readers: the module docstring."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF


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
    (``trace_<pid>_<ns>.json``)."""
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
