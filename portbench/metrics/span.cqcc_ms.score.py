"""``span.cqcc_ms.score``: device ms a call of K5, the CQCC of raw waveforms
(``cqcc.kernel``, one launch a fused call), from the program's own span
readings of the traced window (``_span.py``)."""

from portbench.metrics._span import per_call

SPANS = ("cqcc.kernel",)


def read(ctx: dict) -> float | None:
    return per_call(ctx, SPANS)
