"""``span.w2vbert_relkey_ms.score``: device ms a call of w2v-BERT's relative-key
mask (``w2vbert.rel_key``, 24 a call: ``q E^T``, its gather and scale), from
the program's own span readings of the traced window (``_span.py``)."""

from portbench.metrics._span import per_call

SPANS = ("w2vbert.rel_key",)


def read(ctx: dict) -> float | None:
    return per_call(ctx, SPANS)
