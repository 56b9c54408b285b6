"""ASVspoof metadata ingestion (L2): schema detection and path resolution.

Counterpart of the JAX package's ``data/metadata.py`` (the reference's
``detect_columns`` / ``prepare_filepaths``, reference/ASV_dl_func.py:150-162,
reference/train_fun.py:49-53), without pandas: a metadata table is a list of
row dicts, every field a string. Metadata files are whitespace-separated
with no header; the schema (DF, then PA, then LA) is detected by the column
count of the first line against the configured column lists.

As pandas' ``read_csv(sep=r"\\s+", names=..., on_bad_lines="warn")`` does, a
line with more fields than the schema is skipped with a warning, a line with
fewer gets ``None`` in its missing fields, and blank lines are skipped. The
JAX package's pandas parses numeric-looking fields as numbers; here
``file_id`` and every other field stay the strings in the file.
"""

from __future__ import annotations

import os
import sys

from audioanalysisdetector_tpu_torch.io.config import DEFAULT_COLUMNS


def _field_lines(metadata_path: str):
    """(line number, whitespace-split fields) of each non-blank line."""
    with open(metadata_path) as f:
        for i, line in enumerate(f, 1):
            fields = line.split()
            if fields:
                yield i, fields


def detect_columns(metadata_path: str, schemas: dict[str, list[str]] | None = None) -> list[str]:
    schemas = schemas or DEFAULT_COLUMNS
    n_cols = len(next(_field_lines(metadata_path), (0, []))[1])
    for cols in (schemas.get("DF"), schemas.get("PA"), schemas.get("LA")):
        if cols is not None and n_cols == len(cols):
            return list(cols)
    return [f"c{i}" for i in range(n_cols)]


def read_metadata(metadata_path: str, schemas: dict[str, list[str]] | None = None) -> list[dict]:
    cols = detect_columns(metadata_path, schemas)
    rows = []
    for i, fields in _field_lines(metadata_path):
        if len(fields) > len(cols):
            print(f"WARNING: {metadata_path} line {i}: expected {len(cols)} fields, saw {len(fields)}: skipped",
                  file=sys.stderr)
            continue
        rows.append(dict(zip(cols, fields + [None] * (len(cols) - len(fields)))))
    return rows


def prepare_filepaths(
    rows: list[dict],
    audio_folder: str,
    *,
    file_id_col: str = "file_id",
    extension: str = ".flac",
) -> list[dict]:
    """Resolve ``file_id`` to existing audio paths; drop missing files.

    ``extension`` defaults to the reference's ``.flac``; pass ``".wav"`` for
    WAV corpora."""
    out = []
    for row in rows:
        name = str(row[file_id_col]) + extension
        path = os.path.join(audio_folder, name)
        if os.path.exists(path):
            out.append({**row, "file_name": name, "file_path": path})
    return out
