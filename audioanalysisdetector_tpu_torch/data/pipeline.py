"""Batched feature extraction: decode on the host, features on the device.

Counterpart of the JAX package's ``data/pipeline.py`` (the reference
extracts one file per process through ``joblib``,
reference/ASV_dl_func.py:1031-1049), without pandas: fixed-size waveform
batches are decoded by the threaded native loader, the tail batch padded
with zeros to ``batch_size``, and the frontend runs on whole batches on
``device``. ``extract_features`` keeps the reference's table-in/table-out
contract (one ndarray per cell, ``None`` for a row whose audio failed to
decode), ``extract_feature_array`` returns the stacked array.

``default_extractors`` registers the frontends the port has: ``cqcc`` and
``mel_spectrogram``; the others (mfcc, lfcc, gtcc, wpt, mfcc_deltas,
formants) wait for ROADMAP Queue 1 step 10, and rows that carry an
augmentation wait for step 11.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from audioanalysisdetector_tpu_torch.data.balance import is_null
from audioanalysisdetector_tpu_torch.frontend.cqcc import CQCCConfig, cqcc
from audioanalysisdetector_tpu_torch.frontend.mel import MelConfig, log_mel_spectrogram
from audioanalysisdetector_tpu_torch.io.native_loader import load_chunk_batch_native as load_chunk_batch

# the JAX package's ``data/augment.py`` codes of "no augmentation"
_NO_AUGMENTATION = ("", None)


def default_extractors(sr: int = 16000) -> dict[str, Callable]:
    """Batched frontend extractors by reference column name."""
    return {
        "cqcc": lambda w: cqcc(w, CQCCConfig.for_sr(sr)),
        "mel_spectrogram": lambda w: log_mel_spectrogram(w, MelConfig(sr=sr, n_mels=64)),
    }


def _extractor(registry: dict[str, Callable], name: str) -> Callable:
    if name not in registry:
        raise KeyError(
            f"feature {name!r} is not ported to audioanalysisdetector_tpu_torch yet "
            f"(ROADMAP Queue 1 step 10); ported: {sorted(registry)}"
        )
    return registry[name]


def _refuse_augmented(rows: list[dict], aug_col: str) -> None:
    for r in rows:
        v = r.get(aug_col)
        if not is_null(v) and v not in _NO_AUGMENTATION:
            raise NotImplementedError(
                f"row {r.get('file_path')!r} carries augmentation {v!r}: augmentation is not "
                "ported to audioanalysisdetector_tpu_torch yet (ROADMAP Queue 1 step 11)"
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
    ``extract_features``). ``mean`` pools the time axis (``time_axis`` of
    the feature's layout). ``seed`` keys the augmentations of the JAX
    package, which the port refuses (step 11)."""
    _refuse_augmented(rows, aug_col)
    paths = [r[path_col] for r in rows]
    starts = [r.get("chunk_start", 0.0) for r in rows]
    ends = [r.get("chunk_end", 2.0) for r in rows]
    outs, oks = [], []
    for lo in range(0, len(paths), batch_size):
        hi = min(lo + batch_size, len(paths))
        true = hi - lo
        wav, ok = load_chunk_batch(paths[lo:hi], starts[lo:hi], ends[lo:hi], sr=sr, return_ok=True)
        if true < batch_size:
            wav = np.concatenate([wav, np.zeros((batch_size - true,) + wav.shape[1:], np.float32)])
        feats = feature_fn(torch.from_numpy(wav).to(device))
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
    feature, each an ndarray, or ``None`` where the audio failed to decode
    (reference/ASV_dl_func.py:1031-1049)."""
    if isinstance(feature_extractors_map, list):
        registry = default_extractors(sr)
        feature_extractors_map = {n: _extractor(registry, n) for n in feature_extractors_map}
    rows = [dict(r) for r in rows]
    for name, fn in feature_extractors_map.items():
        arr, ok = extract_feature_array(
            rows, fn, sr=sr, batch_size=batch_size, path_col=col_name, aug_col=aug_col, mean=mean,
            seed=seed, device=device,
        )
        for r, a, good in zip(rows, arr, ok):
            r[name] = a if good else None
    return rows
