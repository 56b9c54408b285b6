"""``idle.serve``: the card's idle share over the traced window, in %."""

from portbench.metrics._idle import idle_percent


def read(ctx: dict) -> float | None:
    return idle_percent(ctx)
