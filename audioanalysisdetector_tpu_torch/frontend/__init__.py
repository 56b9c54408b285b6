"""Batched DSP frontends (PyTorch): every extractor of the JAX package's
``frontend/``, waveforms ``(..., n_samples)`` in, features out.

As in the JAX package, the function ``cqt`` shadows the submodule of the
same name here (and ``stft`` and ``istft`` theirs): import module-level
names from their modules
(``from audioanalysisdetector_tpu_torch.frontend.cqt import _decimate2``).
"""

from audioanalysisdetector_tpu_torch.frontend.cepstral import (
    CepstralConfig,
    gfcc,
    int16_quirk,
    lfcc,
    pre_emphasis,
)
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
from audioanalysisdetector_tpu_torch.frontend.eda import (
    compute_cqt_spec,
    melspectrogram_znorm,
    znorm,
)
from audioanalysisdetector_tpu_torch.frontend.formants import (
    analyze_formants_and_silence,
    burg_lpc,
    formant_tracks,
    intensity_db,
)
from audioanalysisdetector_tpu_torch.frontend.istft import istft
from audioanalysisdetector_tpu_torch.frontend.mel import (
    MelConfig,
    hz_to_mel,
    log_mel_spectrogram,
    mel_filterbank,
    mel_to_hz,
    melspectrogram,
)
from audioanalysisdetector_tpu_torch.frontend.mfcc import (
    MFCCConfig,
    add_deltas,
    cmvn,
    delta,
    mfcc,
    mfcc_deltas_cmvn,
)
from audioanalysisdetector_tpu_torch.frontend.stft import (
    frame_signal,
    n_frames_for,
    power_spectrogram,
    stft,
)
from audioanalysisdetector_tpu_torch.frontend.wpt import wavelet_packet_leaves, wpt_energies

__all__ = [
    "C1_HZ",
    "CQCCConfig",
    "CQTConfig",
    "CepstralConfig",
    "MFCCConfig",
    "MelConfig",
    "add_deltas",
    "amplitude_to_db",
    "analyze_formants_and_silence",
    "burg_lpc",
    "cmvn",
    "compute_cqt_spec",
    "cqcc",
    "cqcc_from_cqt_mag",
    "cqt",
    "cqt_frequencies",
    "dct_ii",
    "dct_ii_matrix",
    "default_n_bins",
    "delta",
    "formant_tracks",
    "frame_signal",
    "gfcc",
    "hz_to_mel",
    "int16_quirk",
    "intensity_db",
    "istft",
    "lfcc",
    "log_mel_spectrogram",
    "mel_filterbank",
    "mel_to_hz",
    "melspectrogram",
    "melspectrogram_znorm",
    "mfcc",
    "mfcc_deltas_cmvn",
    "n_frames_for",
    "power_spectrogram",
    "power_to_db",
    "pre_emphasis",
    "stft",
    "transpose_cqcc",
    "wavelet_packet_leaves",
    "wpt_energies",
    "znorm",
]
