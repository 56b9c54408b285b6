"""Streaming file scoring — decode overlapped with device compute (PyTorch).

Counterpart of the JAX package's ``score/streaming.py``: a producer thread
fills fixed-size waveform batches through the native threaded decoder
(``io/native_loader``: C++ WAV + FLAC) while the consumer scores the
previous batch on the card, so decode and upload hide behind compute.

Teardown contract (as in the JAX package): the producer exits promptly when
the consumer stops consuming — abandoned generators, raising scorers and
normal exhaustion all set the cancellation event and drain the queue
(``tests/test_torch_io_score.py``).
"""

from __future__ import annotations

import math
import queue
import sys
import threading
from typing import Callable, Iterator

import numpy as np
import torch


def _decoded_length(path: str, sr: int) -> int:
    """Samples of the whole file at ``sr``: its frames, or the length the
    polyphase resampler (``io.audio.resample_poly_host``) gives them."""
    from audioanalysisdetector_tpu_torch.io.audio import audio_info

    info = audio_info(path)
    if info.samplerate == sr:
        return info.frames
    g = math.gcd(sr, info.samplerate)
    return -(-info.frames * (sr // g) // (info.samplerate // g))


def tile_pad(row: np.ndarray, length: int) -> np.ndarray:
    """SSL_Anti-spoofing's ``pad`` on a decoded row whose clip holds
    ``length`` samples: a clip at least as long as the row is cut to it (the
    row already is), a shorter one is repeated until it fills the row."""
    n = row.shape[-1]
    if 0 < length < n:
        row[:] = np.tile(row[:length], -(-n // length))[:n]
    return row


def stream_decode_batches(
    paths: list[str],
    *,
    seconds: float = 2.0,
    sr: int = 16000,
    batch_size: int = 512,
    pad: str = "zeros",
    warn_stream=None,
) -> Iterator[tuple[list[str], np.ndarray]]:
    """Yield ``(kept_paths, (len(kept_paths), n) float32)`` decode batches.

    Decode runs on a producer thread (overlapping the consumer's compute);
    unreadable rows are dropped with a warning (the reference's
    failure->skip policy). Unlike the JAX package, the tail batch is not
    padded to ``batch_size``: the kernels take any batch and nothing is
    compiled per shape. A clip shorter than ``seconds`` is filled with
    zeros (``pad="zeros"``, the mel recipe) or repeated (``pad="tile"``,
    SSL-AASIST's ``tile_pad``).
    """
    from audioanalysisdetector_tpu_torch.io.native_loader import load_chunk_batch_native

    if pad not in ("zeros", "tile"):
        raise ValueError(f"pad must be 'zeros' or 'tile', got {pad!r}")

    warn_stream = warn_stream if warn_stream is not None else sys.stderr
    q: queue.Queue = queue.Queue(maxsize=2)
    cancel = threading.Event()  # set by the consumer's finally: stop producing

    def _put(item) -> bool:
        """Bounded put that gives up when the consumer is gone — a dead
        consumer must never leave the producer parked on a full queue."""
        while not cancel.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        # any failure MUST still unblock the consumer: the sentinel goes out
        # via finally, and an exception is forwarded through the queue
        try:
            for i in range(0, len(paths), batch_size):
                if cancel.is_set():
                    return
                chunk = paths[i : i + batch_size]
                out, ok = load_chunk_batch_native(
                    chunk,
                    [0.0] * len(chunk),
                    [float(seconds)] * len(chunk),
                    sr=sr,
                    return_ok=True,
                )
                for p, good in zip(chunk, ok):
                    if not good:
                        print(f"WARNING: cannot read {p}: skipped", file=warn_stream)
                kept = [p for p, good in zip(chunk, ok) if good]
                if len(kept) == 0:
                    continue
                rows = out[ok]
                if pad == "tile":
                    for row, p in zip(rows, kept):
                        tile_pad(row, _decoded_length(p, sr))
                if not _put((kept, rows)):
                    return
        except BaseException as e:  # noqa: BLE001 — forwarded to the consumer
            _put(e)
        finally:
            _put(None)

    th = threading.Thread(target=producer, daemon=True)
    th.start()
    try:
        while True:
            item = q.get()
            if item is None:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        # runs on normal exhaustion, consumer exceptions, AND abandoned
        # generators (GeneratorExit): wake any blocked put, drain, reap
        cancel.set()
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
        th.join(timeout=10.0)


def score_paths(
    scorer: Callable[[torch.Tensor], torch.Tensor],
    paths: list[str],
    *,
    device: str | torch.device = "cuda",
    seconds: float = 2.0,
    sr: int = 16000,
    batch_size: int = 512,
    pad: str = "zeros",
) -> tuple[list[str], np.ndarray]:
    """Score audio files through a batch scorer, streaming.

    ``scorer``: ``(B, n_samples)`` float32 tensor on ``device`` -> ``(B,)``
    scores on the same device, for any ``B`` up to ``batch_size`` (e.g.
    ``score.e2e.make_mel_cnn_bilstm_scorer`` of a model on ``device``). The
    score vectors are copied to the host only after every batch has been
    dispatched, so uploads and device compute overlap without per-batch
    synchronisation. Returns ``(kept_paths, scores)`` aligned; unreadable
    files are skipped. ``pad``: how a short clip fills its row
    (``stream_decode_batches``).
    """
    device = torch.device(device)
    pending: list[tuple[list[str], torch.Tensor]] = []
    for kept, batch_np in stream_decode_batches(
        paths, seconds=seconds, sr=sr, batch_size=batch_size, pad=pad
    ):
        pending.append((kept, scorer(torch.from_numpy(batch_np).to(device))))
    all_paths: list[str] = []
    parts: list[np.ndarray] = []
    for kept, dev_scores in pending:
        all_paths.extend(kept)
        parts.append(dev_scores.cpu().numpy())
    scores = np.concatenate(parts) if parts else np.empty((0,), np.float32)
    return all_paths, scores
