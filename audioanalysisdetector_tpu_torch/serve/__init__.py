"""Serving layer: dynamic micro-batching HTTP scoring service."""

from audioanalysisdetector_tpu_torch.serve.server import (
    BatchingScorer,
    ScoreServer,
    ServiceOverloaded,
    build_mel_scorer,
)

__all__ = ["BatchingScorer", "ScoreServer", "ServiceOverloaded", "build_mel_scorer"]
