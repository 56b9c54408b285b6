"""Batched DSP frontends (PyTorch): STFT power, mel, dB, CQT, CQCC, DCT,
deltas and CMVN.

As in the JAX package, the function ``cqt`` shadows the submodule of the
same name here: import module-level names from their modules
(``from audioanalysisdetector_tpu_torch.frontend.cqt import _decimate2``).
"""

from audioanalysisdetector_tpu_torch.frontend.cqcc import (
    CQCCConfig,
    cqcc,
    cqcc_from_cqt_mag,
    transpose_cqcc,
)
from audioanalysisdetector_tpu_torch.frontend.cqt import (
    C1_HZ,
    CQTConfig,
    cqt,
    cqt_frequencies,
    default_n_bins,
)
from audioanalysisdetector_tpu_torch.frontend.db import amplitude_to_db, power_to_db
from audioanalysisdetector_tpu_torch.frontend.dct import dct_ii, dct_ii_matrix
from audioanalysisdetector_tpu_torch.frontend.mel import (
    MelConfig,
    hz_to_mel,
    log_mel_spectrogram,
    mel_filterbank,
    mel_to_hz,
    melspectrogram,
)
from audioanalysisdetector_tpu_torch.frontend.mfcc import add_deltas, cmvn, delta
from audioanalysisdetector_tpu_torch.frontend.stft import (
    frame_signal,
    n_frames_for,
    power_spectrogram,
)

__all__ = [
    "C1_HZ",
    "CQCCConfig",
    "CQTConfig",
    "MelConfig",
    "add_deltas",
    "amplitude_to_db",
    "cmvn",
    "cqcc",
    "cqcc_from_cqt_mag",
    "cqt",
    "cqt_frequencies",
    "dct_ii",
    "dct_ii_matrix",
    "default_n_bins",
    "delta",
    "frame_signal",
    "hz_to_mel",
    "log_mel_spectrogram",
    "mel_filterbank",
    "mel_to_hz",
    "melspectrogram",
    "n_frames_for",
    "power_spectrogram",
    "power_to_db",
    "transpose_cqcc",
]
