"""``serve.rows_per_dispatch``: utterances per dispatch of the batcher over
the window (``ServeStats``: utterances / batches, counted from the
window's start to its last answer)."""


def read(ctx: dict) -> float | None:
    n = ctx.get("dispatches")
    return ctx["dispatched_utterances"] / n if n else None
