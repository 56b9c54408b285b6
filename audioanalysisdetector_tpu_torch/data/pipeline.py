"""Batched feature extraction: decode on the host, augmentation and features on the device.

Counterpart of the JAX package's ``data/pipeline.py`` (the reference
extracts one file per process through ``joblib``,
reference/ASV_dl_func.py:1031-1049), without pandas: fixed-size waveform
batches are decoded by the threaded native loader, the tail batch padded
with zeros to ``batch_size``, and the frontend runs on whole batches on
``device``. A batch holding any row with an augmentation (the
``augmentationType`` column that ``data/balance.py::add_data_augmentation``
writes) goes through ``data/augment.py::apply_augmentations`` first, drawn
from one ``torch.Generator`` seeded from ``seed``. ``extract_features``
keeps the reference's table-in/table-out contract (one ndarray per cell,
``None`` for a row whose audio failed to decode), ``extract_feature_array``
returns the stacked array.

``default_extractors`` registers every frontend of the JAX package's
registry; ``"formants"`` is routed to the host path
(``_extract_formants_cells``). The JAX package's multi-device batch
sharding waits for ROADMAP Queue 1 step 9.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from audioanalysisdetector_tpu_torch.data.augment import AUG_CODES, apply_augmentations
from audioanalysisdetector_tpu_torch.data.balance import is_null
from audioanalysisdetector_tpu_torch.frontend.cepstral import CepstralConfig, gfcc, lfcc
from audioanalysisdetector_tpu_torch.frontend.cqcc import CQCCConfig, cqcc
from audioanalysisdetector_tpu_torch.frontend.mel import MelConfig, log_mel_spectrogram
from audioanalysisdetector_tpu_torch.frontend.mfcc import MFCCConfig, mfcc, mfcc_deltas_cmvn
from audioanalysisdetector_tpu_torch.frontend.wpt import wpt_energies
from audioanalysisdetector_tpu_torch.io.native_loader import load_chunk_batch_native as load_chunk_batch


def default_extractors(sr: int = 16000) -> dict[str, Callable]:
    """Batched frontend extractors by reference column name."""
    return {
        "mfcc": lambda w: mfcc(w, MFCCConfig.for_sr(sr)),
        "lfcc": lambda w: lfcc(w, CepstralConfig(fs=sr, fb_kind="linear")),
        "cqcc": lambda w: cqcc(w, CQCCConfig.for_sr(sr)),
        "gtcc": lambda w: gfcc(w, CepstralConfig(fs=sr, nfilts=40, fb_kind="gammatone")),
        "wpt": wpt_energies,
        "mel_spectrogram": lambda w: log_mel_spectrogram(w, MelConfig(sr=sr, n_mels=64)),
        # BASELINE config #2: MFCC + delta/delta-delta + per-utterance CMVN.
        # Needs >= 9 frames (chunks >= ~0.26 s) for the Savitzky-Golay deltas;
        # incompatible with mean=True pooling (CMVN makes time means zero) —
        # extract_features guards both.
        "mfcc_deltas": lambda w: mfcc_deltas_cmvn(w, MFCCConfig.for_sr(sr)),
        # "formants" is also accepted by extract_features: DICT cells of 10
        # prosodic scalars for the classical path, host-routed (see
        # _extract_formants_cells), not in this registry.
    }


FORMANTS_FEATURE = "formants"

# features whose OUTPUT layout is time-major (..., T, coeffs) — the spafe
# layout of lfcc/gfcc — vs the repo convention (..., coeffs, T): mean
# pooling reduces the TIME axis of whichever layout the feature uses
TIME_MAJOR_FEATURES = frozenset({"lfcc", "gtcc"})


def _spans(rows: list[dict], path_col: str) -> tuple[list[str], list[float], list[float]]:
    return ([r[path_col] for r in rows], [r.get("chunk_start", 0.0) for r in rows],
            [r.get("chunk_end", 2.0) for r in rows])


def _extract_formants_cells(
    rows: list[dict],
    *,
    sr: int,
    batch_size: int,
    path_col: str,
    device: str | torch.device = "cuda",
) -> list[dict | None]:
    """Per-row prosodic dicts (``analyze_formants_and_silence``): decode
    batched through the native loader, intensity and Burg LPC on
    ``device``, the polynomial roots on the host."""
    from audioanalysisdetector_tpu_torch.frontend.formants import analyze_formants_and_silence
    from audioanalysisdetector_tpu_torch.io.audio import audio_info

    paths, starts, ends = _spans(rows, path_col)
    cells: list[dict | None] = []
    for lo in range(0, len(paths), batch_size):
        hi = min(lo + batch_size, len(paths))
        wav, ok = load_chunk_batch(paths[lo:hi], starts[lo:hi], ends[lo:hi], sr=sr, return_ok=True)
        # trim each row to the file's TRUE duration: the batch loader
        # zero-pads short reads to the fixed window, and padding silence
        # would dominate silence_ratio / segment stats (the reference's
        # Praat analysis sees the unpadded file, ASV_dl_func.py:343-401)
        true_n = []
        for j in range(lo, hi):
            try:
                info = audio_info(paths[j])
                avail = info.frames / info.samplerate - float(starts[j])
                true_n.append(int(max(0.0, min(avail, ends[j] - starts[j])) * sr))
            except Exception:  # unreadable: row already flagged by the loader
                true_n.append(wav.shape[1])
        for row, good, n_real in zip(wav, ok, true_n):
            if not good:
                cells.append(None)
                continue
            try:
                cells.append(analyze_formants_and_silence(row[: max(n_real, 1)], sr, device=device))
            except (ValueError, FloatingPointError) as e:
                # reference error policy (reference/ASV_dl_func.py:399-401):
                # a failing row (e.g. shorter than the analysis window)
                # becomes a None cell for filtr_nan, not a batch abort
                print(f"WARNING: formants failed for row {len(cells)}: {e}")
                cells.append(None)
    return cells


def _aug_codes_from(rows: list[dict], aug_col: str) -> np.ndarray:
    return np.asarray(
        [0 if is_null(r.get(aug_col)) else AUG_CODES.get(r[aug_col], 0) for r in rows], dtype=np.int32
    )


@torch.no_grad()
def extract_feature_array(
    rows: list[dict],
    feature_fn: Callable,
    *,
    sr: int = 16000,
    batch_size: int = 256,
    path_col: str = "file_path",
    aug_col: str = "augmentationType",
    mean: bool = False,
    time_axis: int = -1,
    seed: int = 0,
    device: str | torch.device = "cuda",
) -> tuple[np.ndarray, np.ndarray]:
    """((len(rows), ...) features, (len(rows),) ok-mask), batched through
    ``device``. Rows whose audio could not be decoded carry zero features
    and ``ok=False`` (the reference's failure->None policy, applied by
    ``extract_features``). A batch with augmented rows runs
    ``apply_augmentations`` before ``feature_fn``, drawing from one
    generator seeded from ``seed``. ``mean`` pools the time axis
    (``time_axis`` of the feature's layout); a feature with no time axis
    (wpt's (B, 8) band energies) passes through unchanged."""
    paths, starts, ends = _spans(rows, path_col)
    codes = _aug_codes_from(rows, aug_col)
    generator = torch.Generator(device=device).manual_seed(seed)
    outs, oks = [], []
    for lo in range(0, len(paths), batch_size):
        hi = min(lo + batch_size, len(paths))
        true = hi - lo
        wav, ok = load_chunk_batch(paths[lo:hi], starts[lo:hi], ends[lo:hi], sr=sr, return_ok=True)
        if true < batch_size:
            wav = np.concatenate([wav, np.zeros((batch_size - true,) + wav.shape[1:], np.float32)])
        aug = np.zeros(batch_size, np.int32)
        aug[:true] = codes[lo:hi]
        wav_dev = torch.from_numpy(wav).to(device)
        if aug.any():
            # only batches that hold augmented rows pay for the augmentations
            wav_dev = apply_augmentations(wav_dev, torch.from_numpy(aug).to(device), generator)
        feats = feature_fn(wav_dev)
        if mean and feats.ndim > 2:
            feats = torch.mean(feats, dim=time_axis)
        outs.append(feats.cpu().numpy()[:true])
        oks.append(ok)
    if not outs:
        return np.empty((0,)), np.empty((0,), bool)
    return np.concatenate(outs), np.concatenate(oks)


def extract_features(
    rows: list[dict],
    feature_extractors_map: dict[str, Callable] | list[str],
    *,
    sr: int = 16000,
    batch_size: int = 256,
    col_name: str = "file_path",
    aug_col: str = "augmentationType",
    mean: bool = False,
    seed: int = 0,
    device: str | torch.device = "cuda",
) -> list[dict]:
    """Reference ``extract_features`` contract: new rows with one cell per
    feature, each an ndarray (a dict for ``"formants"``), or ``None`` where
    the audio failed (reference/ASV_dl_func.py:1031-1049)."""
    if isinstance(feature_extractors_map, list):
        registry = default_extractors(sr)
        feature_extractors_map = {
            n: (FORMANTS_FEATURE if n == FORMANTS_FEATURE else registry[n]) for n in feature_extractors_map
        }
    if mean and "mfcc_deltas" in feature_extractors_map:
        raise ValueError(
            "mfcc_deltas is CMVN-normalized per utterance: its time mean is "
            "identically zero, so mean=True pooling would yield all-zero "
            "features — pool plain 'mfcc' instead"
        )
    rows = [dict(r) for r in rows]
    for name, fn in feature_extractors_map.items():
        # the host formants path routes by VALUE (the sentinel) or by a
        # non-callable under the name; a user-supplied callable mapped as
        # "formants" is honored as a device extractor
        if fn is FORMANTS_FEATURE or (name == FORMANTS_FEATURE and not callable(fn)):
            cells = _extract_formants_cells(rows, sr=sr, batch_size=batch_size, path_col=col_name, device=device)
            for r, c in zip(rows, cells):
                r[name] = c
            continue
        arr, ok = extract_feature_array(
            rows, fn, sr=sr, batch_size=batch_size, path_col=col_name, aug_col=aug_col, mean=mean,
            time_axis=-2 if name in TIME_MAJOR_FEATURES else -1, seed=seed, device=device,
        )
        for r, a, good in zip(rows, arr, ok):
            r[name] = a if good else None
    return rows
