"""``span.model_ms.score``: device ms a call of the scorer's model
(``score.model``: CNN-BiLSTM; ``fused_scores``; AASIST; MHFA), from the
program's own span readings of the traced window (``_span.py``)."""

from portbench.metrics._span import per_call

SPANS = ("score.model",)


def read(ctx: dict) -> float | None:
    return per_call(ctx, SPANS)
