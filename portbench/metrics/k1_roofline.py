"""``k1_roofline``: K1's share of its roofline, in %: the least time the
card could take for one launch's mel power on the cell's configuration
(``yardstick/counts.py::mel_bound``: a real FFT of ``n_fft`` points a frame,
the window, |X|^2 and the mel weights at 67 TFLOP/s, or the waveform read
and the mel power written at 3.35 TB/s, the larger) over the mean device
time of its launches in the traced window. K1 is the direct-DFT mel kernel
of ``ops/csrc/wave_mel.cu``; its CUDA template is ``mel_core``, which K2
shares, and no cell runs K2. Nothing to read (None) where no launch ran."""

from portbench.yardstick.counts import mel_bound

KERNEL = "mel_core"


def read(ctx: dict) -> float | None:
    t, rows = ctx.get("trace"), ctx.get("utterances_per_call")
    if t is None or rows is None:
        return None
    times = [d for name, ds in t.kernels.items() if KERNEL in name for d in ds]
    if not times:
        return None
    return 100.0 * mel_bound(ctx["config"], rows)["bound_s"] / (sum(times) / len(times))
