"""Utilities (PyTorch port): the profiling subsystem and plotting helpers.

The JAX package's ``utils/compile_cache.py`` has no counterpart here: it
turns on XLA's persistent compilation cache, and torch has no XLA programs
to cache. The port's only compiled code is its hand-written kernels, which
``ops/_build.py`` builds once per source hash into ``build/torch_kernels/``
and reuses from there.
"""

from audioanalysisdetector_tpu_torch.utils.plotting import plot_coeff_histograms_by_label
from audioanalysisdetector_tpu_torch.utils.profiling import StepTimer, device_trace, span

__all__ = [
    "StepTimer",
    "device_trace",
    "plot_coeff_histograms_by_label",
    "span",
]
