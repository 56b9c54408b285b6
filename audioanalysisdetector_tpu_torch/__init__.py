"""audioanalysisdetector_tpu_torch — the detector on PyTorch and CUDA.

A port of the JAX package beside it (JAX on a TPU) to PyTorch on an
NVIDIA H100, module for module at the same paths. The JAX package is the
frozen reference: every ported function is tested against it on the same
inputs and weights. This package imports torch and numpy, never jax.

Ported so far: the mel scoring path, wav -> log-mel -> CNN-BiLSTM -> score,
served over HTTP and over files from disk (``score`` command); and the
flagship fused scorer, wav -> CQCC -> GMM ⊕ BiLSTM, with the loaders of a
JAX-trained model dir.

- ``frontend``: STFT power, Slaney mel, dB (``melspectrogram`` launches a
  hand-written kernel on CUDA tensors: ``ops.ct_mel`` at the parity
  profile, ``ops.wave_mel`` elsewhere); CQT, CQCC, DCT, deltas, CMVN.
- ``ops``:      hand-written Hopper kernels (CUDA C++, built with nvcc at
  first use) beside their plain PyTorch versions.
- ``models``:   BiLSTM, the CNN-BiLSTM hybrid, the fused system's BiLSTM
  classifier and diagonal-GMM scoring.
- ``score``:    the end-to-end mel and fused scorers; streaming file scoring.
- ``serve``:    the micro-batching HTTP service; ``cli`` the command line.
- ``io``:       WAV/FLAC decoders and the native batch loader (host side).
- ``train``:    JAX checkpoint reading, host metrics, the GMM system's load
  and evaluation side; ``data``: the frame scaler.
- ``convert``:  flax parameters -> the port's state_dict.
"""

__version__ = "0.1.0"

from audioanalysisdetector_tpu_torch.frontend import (  # noqa: F401
    MelConfig,
    amplitude_to_db,
    log_mel_spectrogram,
    melspectrogram,
    power_to_db,
)
