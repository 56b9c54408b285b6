"""``serve.dispatch_ms``: mean milliseconds of one call of the model step
under serving (``build_mel_scorer``'s scorer: upload, scoring, fetch),
timed on the host clock by the benchmark's wrapper around the scorer it
hands to ``BatchingScorer`` (``drivers/serve.py``)."""


def read(ctx: dict) -> float | None:
    times = ctx.get("dispatch_s")
    return 1e3 * sum(times) / len(times) if times else None
