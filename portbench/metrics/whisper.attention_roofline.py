"""``whisper.attention_roofline``: Whisper's attention kernel's share of its
roofline, in %: the least time the card could take for one layer's
attention over the cell's batch (``yardstick/whisper_mhfa.py::
attention_bound``: ``Q K^T`` and ``A V`` over T = 1,500 at the TF32 tensor
peak, or Q, K, V and the output at 3.35 TB/s, the larger) over the mean
device time of the attention launches in the traced window. Nothing to read
(None) where no such launch ran.

A reader of its own, not ``xlsr.attention_roofline`` with this cell
appended: that reader's ``attention_bound`` takes T from XLS-R's conv stack
(``yardstick/xlsr_aasist.py::conv_lengths`` reads ``conv_kernels``), which
this configuration does not have.
"""

from portbench.yardstick.whisper_mhfa import attention_bound

# torch's float32 scaled-dot-product attention on the card, no mask: the
# memory-efficient (CUTLASS) forward kernel,
# ``fmha_cutlassF_f32_aligned_64x64_rf_sm80``
KERNEL = "fmha_cutlassF"


def read(ctx: dict) -> float | None:
    t, rows = ctx.get("trace"), ctx.get("utterances_per_call")
    if t is None or rows is None:
        return None
    times = [d for name, ds in t.kernels.items() if KERNEL in name for d in ds]
    if not times:
        return None
    return 100.0 * attention_bound(ctx["config"], rows)["bound_s"] / (sum(times) / len(times))
