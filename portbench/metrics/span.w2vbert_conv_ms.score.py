"""``span.w2vbert_conv_ms.score``: device ms a call of w2v-BERT's convolution
modules (``w2vbert.conv_module``, 24 a call), from the program's own span
readings of the traced window (``_span.py``)."""

from portbench.metrics._span import per_call

SPANS = ("w2vbert.conv_module",)


def read(ctx: dict) -> float | None:
    return per_call(ctx, SPANS)
