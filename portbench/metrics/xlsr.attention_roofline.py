"""``xlsr.attention_roofline``: XLS-R's attention kernel's share of its
roofline, in %: the least time the card could take for one layer's
attention over the cell's batch (``yardstick/xlsr_aasist.py::attention_bound``:
operations at the TF32 tensor peak or bytes at 3.35 TB/s, the larger) over
the mean device time of the attention launches in the traced window.
Nothing to read (None) where no such launch ran."""

from portbench.yardstick.xlsr_aasist import attention_bound

# torch's float32 scaled-dot-product attention on the card: the
# memory-efficient (CUTLASS) forward kernel
KERNEL = "fmha_cutlassF"


def read(ctx: dict) -> float | None:
    t, rows = ctx.get("trace"), ctx.get("utterances_per_call")
    if t is None or rows is None:
        return None
    times = [d for name, ds in t.kernels.items() if KERNEL in name for d in ds]
    if not times:
        return None
    return 100.0 * attention_bound(ctx["config"], rows)["bound_s"] / (sum(times) / len(times))
