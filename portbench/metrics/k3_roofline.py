"""``k3_roofline``: K3's (``ct_mel_kernel``) share of its roofline, in %:
the least time the card could take for one launch's mel power
(``yardstick/counts.py::mel_bound``: operations at 67 TFLOP/s or bytes at
3.35 TB/s, the larger) over the mean device time of its launches in the
traced window."""

from portbench.yardstick.counts import mel_bound

KERNEL = "ct_mel_kernel"


def read(ctx: dict) -> float | None:
    t, rows = ctx.get("trace"), ctx.get("utterances_per_call")
    if t is None or rows is None:
        return None
    times = [d for name, ds in t.kernels.items() if KERNEL in name for d in ds]
    if not times:
        return None
    return 100.0 * mel_bound(ctx["config"], rows)["bound_s"] / (sum(times) / len(times))
