"""``span.wavlm_bias_ms.score``: device ms a call of WavLM's attention bias
(``wavlm.position_bias`` once a call, ``wavlm.gated_bias`` 24 a call: the gate
and ``G·P``), from the program's own span readings of the traced window
(``_span.py``)."""

from portbench.metrics._span import per_call

SPANS = ("wavlm.position_bias", "wavlm.gated_bias")


def read(ctx: dict) -> float | None:
    return per_call(ctx, SPANS)
