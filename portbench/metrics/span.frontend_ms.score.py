"""``span.frontend_ms.score``: device ms a call of the scorer's features
(``score.frontend``: log-mel; CQCC; XLS-R's, WavLM's or w2v-BERT's hidden
states), from the program's own span readings of the traced window
(``_span.py``)."""

from portbench.metrics._span import per_call

SPANS = ("score.frontend",)


def read(ctx: dict) -> float | None:
    return per_call(ctx, SPANS)
