"""``train.step_ms``: milliseconds of one ``make_train_step`` step (forward,
backward, Adam) on the cell's batches, CUDA events over 50 steps after the
window (``drivers/train.py::step_readings``)."""


def read(ctx: dict) -> float | None:
    return ctx.get("step_ms")
