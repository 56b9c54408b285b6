"""``mfu.train``: the training step's share of the card's float32 peak, in
%: the yardstick's operations per training utterance (forward and backward
of the model, three forward passes' worth, from the configuration's
shapes) times the traced window's rate, over 67 TFLOP/s."""

from portbench.yardstick.peaks import FP32_FLOP_PER_S


def read(ctx: dict) -> float | None:
    rate, ops = ctx.get("rate_utt_per_s"), ctx.get("train_ops")
    if rate is None or ops is None or ctx.get("trace") is None or not ctx["trace"].kernels:
        return None
    return 100.0 * ops(ctx["config"]) * rate / FP32_FLOP_PER_S
