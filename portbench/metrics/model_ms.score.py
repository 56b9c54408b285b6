"""``model_ms.score``: milliseconds of the scorer's model on one batch of the
cell (CUDA events over repeated calls on the cell's first pool batch,
after the window; ``drivers/offline.py``)."""


def read(ctx: dict) -> float | None:
    if ctx.get("trace") is None or not ctx["trace"].kernels:
        return None
    return ctx.get("model_ms")
