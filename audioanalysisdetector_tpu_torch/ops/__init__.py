"""Hand-written Hopper kernels, each beside its plain PyTorch version.

Import from the kernel's own module (``ops.wave_mel``): it also holds the
kernel's launch counter, which a re-export here would shadow.
"""
