"""Dataset assembly: duration probing, 2-s chunking, balancing, sampling.

Counterpart of the JAX package's ``data/dataset.py`` (the reference's
``prepare_dataframe``, reference/ASV_dl_func.py:247-340, and
``prepare_dirs_dataset``, :165-244), without pandas:
tables are lists of row dicts, and every draw is the one the JAX package's
pandas calls make, so both packages emit the same rows in the same order.
Every audio file is probed (header only, no decode), files shorter than the
chunk length are skipped with a warning, and one row per full chunk is
emitted with ``chunk_index``/``chunk_start``/``chunk_end``. Per-class
balancing downsamples to the minimum class subject to a minimum count; a
rescue CSV snapshots the expensive scan (written with the ``csv`` module:
the same columns and rows as pandas' ``to_csv``).
"""

from __future__ import annotations

import csv
import os
import wave
from collections import Counter

from audioanalysisdetector_tpu_torch.data.balance import sample_rows
from audioanalysisdetector_tpu_torch.data.metadata import prepare_filepaths, read_metadata
from audioanalysisdetector_tpu_torch.io.audio import audio_info


def chunk_rows(
    rows: list[dict],
    *,
    path_col: str = "file_path",
    chunk_seconds: float = 2.0,
    verbose: bool = True,
) -> list[dict]:
    """Expand file rows into fixed-length chunk rows (skip short/unreadable)."""
    out = []
    for row in rows:
        fpath = row[path_col]
        try:
            info = audio_info(fpath)
        except (RuntimeError, OSError, EOFError, ValueError, wave.Error) as e:
            if verbose:
                print(f"WARNING: cannot read {fpath}: {e}")
            continue
        duration = info.duration
        if duration < chunk_seconds:
            if verbose:
                print(f"too short: {fpath}")
            continue
        for i in range(int(duration // chunk_seconds)):
            out.append({**row, "chunk_index": i, "chunk_start": i * chunk_seconds,
                        "chunk_end": (i + 1) * chunk_seconds})
    return out


def _balance_downsample(
    rows: list[dict], min_per_class: int, *, label_col: str = "label", seed: int = 42
) -> list[dict]:
    """Each class (in sorted label order) sampled down to the smallest
    class's count, as ``groupby(label).apply(sample(n, random_state=seed))``."""
    counts = Counter(r[label_col] for r in rows)
    if not all(c >= min_per_class for c in counts.values()):
        print(f"not enough data to balance (need >= {min_per_class} per class): {dict(counts)}")
        return rows
    min_class = max(min(counts.values()), min_per_class)
    out = []
    for label in sorted(counts):
        out += sample_rows([r for r in rows if r[label_col] == label], min_class, seed)
    return out


def _write_rescue_csv(path: str, rows: list[dict], *, index: bool = True) -> None:
    """pandas ``to_csv(index=index)`` of the rows: an index column if
    ``index``, then every column."""
    cols = list(dict.fromkeys(k for r in rows for k in r))
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")  # pandas' line ending, not csv's "\r\n"
        w.writerow(([""] if index else []) + cols)
        for i, r in enumerate(rows):
            w.writerow(([i] if index else []) + ["" if r.get(c) is None else r[c] for c in cols])


def prepare_dataframe(
    all_data: dict,
    *,
    balance: bool = True,
    sample_size: int | None = 2000,
    min_per_class: int = 400,
    df_train: list[dict] | None = None,
    chunk_seconds: float = 2.0,
    extension: str = ".flac",
    rescue_dir: str | None = ".",
    seed: int = 42,
) -> list[dict]:
    """Assemble a chunked dataset from dataset config blocks.

    ``all_data`` maps dataset keys to ``{"metadata": path, "flac": [dirs]}``
    (the reference's config schema). When ``df_train`` is given, its file
    paths are excluded (held-out test assembly) and sampling caps are skipped.
    Rows of every key and folder are concatenated keeping only the columns
    all of them have (pandas' inner join).
    """
    dfs = []
    existing = {r["file_path"] for r in df_train if "file_path" in r} if df_train else set()
    for key, value in all_data.items():
        metadata_path = value["metadata"]
        try:  # one parse per key, not per audio folder
            meta = read_metadata(metadata_path)
        except FileNotFoundError:
            print(f"WARNING: metadata file not found: {metadata_path}")
            continue
        key_chunks = []  # rescue snapshot accumulates across ALL folders of a key
        for audio_folder in value["flac"]:
            rows = prepare_filepaths(meta, audio_folder, extension=extension)
            if not rows:
                continue
            if existing:
                rows = [r for r in rows if r["file_path"] not in existing]
            rows = chunk_rows(rows, chunk_seconds=chunk_seconds)
            if not rows:
                continue
            print(f"found {len(rows)} {chunk_seconds}-s chunks for {key}")
            key_chunks += rows
            if balance and "label" in rows[0]:
                rows = _balance_downsample(rows, min_per_class, seed=seed)
            if df_train is None and sample_size:
                rows = sample_rows(rows, min(len(rows), sample_size), seed)
            dfs.append(rows)
        if rescue_dir is not None and key_chunks:
            _write_rescue_csv(os.path.join(rescue_dir, f"{key}_ratunkowe.csv"), key_chunks)
    if not dfs:
        print("ERROR: no data loaded; check paths and config")
        return []
    cols = [c for c in dfs[0][0] if all(c in rows[0] for rows in dfs)]
    return [{c: r[c] for c in cols} for rows in dfs for r in rows]


def prepare_dirs_dataset(
    dir_path: str,
    *,
    balance: bool = True,
    min_per_class: dict[str, int] | None = None,
    sample_size: int | None = 5000,
    chunk_seconds: float = 2.0,
    rescue_dir: str | None = ".",
    seed: int = 42,
) -> list[list[dict]]:
    """Chunked datasets, one table per subset, from
    ``dir/{train,val,test}/{label}/file`` layouts ("in the wild" data,
    reference/ASV_dl_func.py:165-244)."""
    if min_per_class is None:
        min_per_class = {"train": 300, "val": 10, "test": 5}
    dfs = []
    subsets = [d for d in sorted(os.listdir(dir_path)) if os.path.isdir(os.path.join(dir_path, d))]
    for subset in subsets:
        set_path = os.path.join(dir_path, subset)
        records = []
        for label in sorted(os.listdir(set_path)):
            label_path = os.path.join(set_path, label)
            if not os.path.isdir(label_path):
                continue
            for file in sorted(os.listdir(label_path)):
                records.append({"set": subset, "filepath": os.path.join(label_path, file), "label": label})
        rows = chunk_rows(records, path_col="filepath", chunk_seconds=chunk_seconds)
        if not rows:
            print(f"no data in {subset}, skipping")
            continue
        if rescue_dir is not None:
            _write_rescue_csv(os.path.join(rescue_dir, f"{subset}_ratunkowe.csv"), rows, index=False)
        if balance:
            rows = _balance_downsample(rows, min_per_class.get(subset, 5), seed=seed)
        if sample_size and len(rows) > sample_size:
            rows = sample_rows(rows, sample_size, seed)
        dfs.append(rows)
    return dfs
