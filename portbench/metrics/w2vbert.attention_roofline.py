"""``w2vbert.attention_roofline``: w2v-BERT 2.0's relative-key attention
kernel's share of its roofline, in %: the least time the card could take
for one layer's attention over the cell's batch
(``yardstick/w2vbert_mhfa.py::attention_bound``: ``Q K^T``, ``A V`` and
``q E^T`` at the TF32 tensor peak or Q, K, V, the output and ``q E^T`` at
3.35 TB/s, the larger) over the mean device time of the attention launches
in the traced window. Nothing to read (None) where no such launch ran.

A reader of its own, not ``xlsr.attention_roofline`` with this cell
appended: that reader's ``attention_bound`` takes T from XLS-R's conv stack
(``yardstick/xlsr_aasist.py::conv_lengths`` reads ``conv_kernels``), which
this configuration does not have, and counts no relative-key product.
"""

from portbench.yardstick.w2vbert_mhfa import attention_bound

# torch's float32 scaled-dot-product attention with a float mask on the
# card: the memory-efficient (CUTLASS) forward kernel,
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
