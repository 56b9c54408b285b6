"""The device's idle share of a traced window, shared by the ``idle.*``
readers: 1 - (union of device operation intervals) / window, in %."""


def idle_percent(ctx: dict) -> float | None:
    t = ctx.get("trace")
    if t is None or not t.kernels or t.window_s <= 0:
        return None
    return 100.0 * t.idle_share
