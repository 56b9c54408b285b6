"""Serving layer: dynamic micro-batching HTTP scoring service, one process
or N HTTP workers in front of one card owner (``serve/multiproc.py``)."""

from audioanalysisdetector_tpu_torch.serve.multiproc import MultiprocessServer
from audioanalysisdetector_tpu_torch.serve.server import (
    BatchingScorer,
    ScoreServer,
    ServiceOverloaded,
    build_mel_scorer,
)

__all__ = ["BatchingScorer", "MultiprocessServer", "ScoreServer", "ServiceOverloaded", "build_mel_scorer"]
