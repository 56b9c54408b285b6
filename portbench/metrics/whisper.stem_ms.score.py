"""``whisper.stem_ms.score``: device ms a call of Whisper's conv stem
(``whisper.conv_stem``: both convs with their GELUs, once a call), from the
program's own span readings of the traced window (``_span.py``)."""

from portbench.metrics._span import per_call

SPANS = ("whisper.conv_stem",)


def read(ctx: dict) -> float | None:
    return per_call(ctx, SPANS)
