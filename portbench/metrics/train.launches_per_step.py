"""``train.launches_per_step``: device operations (kernels, copies, fills)
the profiler records per ``make_train_step`` step, over 5 steps after the
window (``drivers/train.py::step_readings``)."""


def read(ctx: dict) -> float | None:
    return ctx.get("launches_per_step")
