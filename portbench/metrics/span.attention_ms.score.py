"""``span.attention_ms.score``: device ms a call of the SSL front ends' attention
(``ssl.attend``, ``models/wav2vec2.py::attend``: the float mask's pad copy and
fills, the attention kernel, the merge transpose; 24 a call), from the
program's own span readings of the traced window (``_span.py``)."""

from portbench.metrics._span import per_call

SPANS = ("ssl.attend",)


def read(ctx: dict) -> float | None:
    return per_call(ctx, SPANS)
