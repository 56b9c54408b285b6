"""``voxtral.lm_attention_roofline``: the decoder's causal attention's share
of its roofline, in %: the least time the card could take for a call's
decoder attention (``yardstick/voxtral_detect.py::lm_attention_bound``:
``Q K^T`` and ``A V`` over the causal pairs of all 30 layers at the TF32
tensor peak, or Q, K, V and the output at 3.35 TB/s, the larger) over the
``lm.attend`` span reading a call (``_span.py``: SDPA, the K/V expansion to
the query heads and the merge). Nothing to read (None) where the program
has no such span.

Read from the span and not from the trace by kernel name: the encoder's
mask-free attention and the decoder's causal one run instances of one
CUTLASS kernel template (``fmha_cutlassF_f32_aligned_64x64_rf_sm80`` for
the encoder's 64-wide heads, ``..._64x128_rf_sm80`` for the decoder's
128-wide ones), told apart only by the tile size torch picks.
"""

from portbench.metrics._span import per_call
from portbench.yardstick.voxtral_detect import lm_attention_bound

SPANS = ("lm.attend",)


def read(ctx: dict) -> float | None:
    ms, rows = per_call(ctx, SPANS), ctx.get("utterances_per_call")
    if ms is None or not rows:
        return None
    return 100.0 * lm_attention_bound(ctx["config"], rows)["bound_s"] / (ms / 1e3)
