"""``span.lstm_ms.score``: device ms a call of the BiLSTM layers (``lstm.layer``,
every ``models/lstm.py::BiLSTM`` call: K4 with its input products, or cuDNN;
two a fused call, one a mel call), from the program's own span readings of the
traced window (``_span.py``)."""

from portbench.metrics._span import per_call

SPANS = ("lstm.layer",)


def read(ctx: dict) -> float | None:
    return per_call(ctx, SPANS)
