"""audioanalysisdetector_tpu_torch — the detector on PyTorch and CUDA.

A port of the JAX package beside it (JAX on a TPU) to PyTorch on an
NVIDIA H100, module for module at the same paths. The JAX package is the
frozen reference: every ported function is tested against it on the same
inputs and weights. This package imports torch and numpy, never jax.

Ported so far: the mel scoring path, wav -> log-mel -> CNN-BiLSTM -> score,
served over HTTP and over files from disk (``score`` command); the flagship
fused scorer, wav -> CQCC -> GMM ⊕ BiLSTM, with the loaders of a
JAX-trained model dir; training: the CNN-BiLSTM (``train``), the
BiLSTM classifier and the GMM-UBM (EM, MAP), with the flagship
``train-fused`` and ``train-asvspoof`` recipes; and every feature extractor
with the augmentations (``extract``, ``augment``).

- ``frontend``: STFT power, Slaney mel, dB (``melspectrogram`` launches a
  hand-written kernel on CUDA tensors: ``ops.ct_mel`` at the parity
  profile, ``ops.wave_mel`` elsewhere); STFT and iSTFT, MFCC, deltas,
  CMVN, LFCC/GFCC, CQT, CQCC, DCT, wavelet-packet energies, the EDA
  spectrograms, formants.
- ``ops``:      hand-written Hopper kernels (CUDA C++, built with nvcc at
  first use) beside their plain PyTorch versions.
- ``models``:   BiLSTM, the CNN-BiLSTM hybrid, the fused system's BiLSTM
  classifier and the diagonal GMM (scoring, EM, MAP).
- ``score``:    the end-to-end mel and fused scorers; streaming file scoring.
- ``serve``:    the micro-batching HTTP service; ``cli`` the command line.
- ``io``:       WAV/FLAC decoders, the native batch loader, YAML config.
- ``train``:    losses, optimizers, loops, checkpoints in the JAX package's
  format, metrics, the GMM-UBM system, the surrogate quality lane;
  ``data``:     metadata, chunking, balancing, augmentation (noise, shift,
  phase-vocoder pitch shift, SpecAugment), batched feature extraction
  (tables are lists of row dicts: no pandas), the frame scaler, bucketing,
  the synthetic surrogate corpus.
- ``convert``:  flax parameters -> the port's state_dict.
"""

__version__ = "0.1.0"

from audioanalysisdetector_tpu_torch.frontend import (  # noqa: F401
    MelConfig,
    MFCCConfig,
    amplitude_to_db,
    log_mel_spectrogram,
    melspectrogram,
    mfcc,
    power_to_db,
    stft,
)
