"""``whisper.logmel_ms.score``: device ms a call of Whisper's log-mel
(``whisper.log_mel``: the center pad, K1 and the normalisation, once a
call), from the program's own span readings of the traced window
(``_span.py``)."""

from portbench.metrics._span import per_call

SPANS = ("whisper.log_mel",)


def read(ctx: dict) -> float | None:
    return per_call(ctx, SPANS)
