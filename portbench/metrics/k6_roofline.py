"""``k6_roofline``: K6's (``gmm_llr_kernel``) share of its roofline, in %:
the least time the card could take for one launch's GMM arm over a call's
utterances, the larger of both GMMs' log-densities
(``yardstick/counts.py::gmm_pair_ops`` an utterance) at 67 TFLOP/s and the
bytes (each frame's coefficients read once, each utterance's LLR and empty
flag written once) at 3.35 TB/s, over the mean device time of its launches
in the traced window. None where no such launch ran."""

from portbench.yardstick.counts import frames, gmm_pair_ops
from portbench.yardstick.peaks import FP32_FLOP_PER_S, HBM_BYTES_PER_S

KERNEL = "gmm_llr_kernel"


def bound_s(cfg: dict, utterances: int) -> float:
    t = frames(cfg["n_samples"], cfg["hop_length"])
    ops = utterances * gmm_pair_ops(cfg)
    nbytes = utterances * (4 * t * cfg["n_ceps"] + 4 + 1)
    return max(ops / FP32_FLOP_PER_S, nbytes / HBM_BYTES_PER_S)


def read(ctx: dict) -> float | None:
    t, rows = ctx.get("trace"), ctx.get("utterances_per_call")
    if t is None or rows is None:
        return None
    times = [d for name, ds in t.kernels.items() if KERNEL in name for d in ds]
    if not times:
        return None
    return 100.0 * bound_s(ctx["config"], rows) / (sum(times) / len(times))
