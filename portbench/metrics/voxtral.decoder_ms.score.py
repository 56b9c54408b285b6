"""``voxtral.decoder_ms.score``: device ms a call of Voxtral's decoder
(``voxtral.decoder``: the 30 layers, each with its ``lm.attend``, once a
call), from the program's own span readings of the traced window
(``_span.py``)."""

from portbench.metrics._span import per_call

SPANS = ("voxtral.decoder",)


def read(ctx: dict) -> float | None:
    return per_call(ctx, SPANS)
