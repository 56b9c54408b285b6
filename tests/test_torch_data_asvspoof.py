"""The port's pandas-free data layer against the JAX package's pandas one, on the CPU.

Metadata ingestion, chunking, dataset assembly with its sampling draws, the
balancers, ``prepare_data_gmm_bilstm`` and ``extract_features(["cqcc"])``
run on the same files in both packages; the JAX DataFrames are compared
with the port's row lists record by record. The surrogate corpus the port
writes is the JAX package's, byte for byte.
"""

import contextlib
import math
import os

import numpy as np
import pandas as pd
import pytest
import torch

from audioanalysisdetector_tpu.data import balance as jbal
from audioanalysisdetector_tpu.data import dataset as jds
from audioanalysisdetector_tpu.data import metadata as jmeta
from audioanalysisdetector_tpu.data import pipeline as jpipe
from audioanalysisdetector_tpu.data.shape_utils import prepare_data_gmm_bilstm as j_prepare_gmm
from audioanalysisdetector_tpu.data.synthetic import make_surrogate_corpus as j_corpus
from audioanalysisdetector_tpu.io.config import DEFAULT_COLUMNS as J_DEFAULT_COLUMNS
from audioanalysisdetector_tpu_torch.data import balance, dataset, metadata, pipeline
from audioanalysisdetector_tpu_torch.data.shape_utils import prepare_data_gmm_bilstm
from audioanalysisdetector_tpu_torch.data.synthetic import make_surrogate_corpus
from audioanalysisdetector_tpu_torch.io.audio import write_wav
from audioanalysisdetector_tpu_torch.io.config import DEFAULT_COLUMNS, loads_config

torch.set_num_threads(2)

# CQCC cells, absolute, on coefficients up to ~50 (tests/test_torch_cqcc.py's
# CQCC_TOL: fp32 rounding of log(dB^2 + 1e-12) and the DCT sum)
CQCC_TOL = 2e-4
CORPUS = dict(n_bonafide=4, n_spoof_per_tier=2, seconds=4.5, seed=3, channel="varied")


def _plain(v):
    """A pandas cell as the port keeps it: numpy scalars as Python ones, NaN as None."""
    if isinstance(v, np.generic):
        v = v.item()
    if isinstance(v, float) and math.isnan(v):
        return None
    return v


def _records(df: pd.DataFrame, skip=()) -> list[dict]:
    return [{k: _plain(v) for k, v in r.items() if k not in skip} for r in df.to_dict("records")]


def _strip(rows: list[dict], skip=()) -> list[dict]:
    return [{k: v for k, v in r.items() if k not in skip} for r in rows]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The surrogate corpus written by both packages, plus a short and a
    broken file listed in the port's metadata."""
    root = tmp_path_factory.mktemp("corpus")
    ours = make_surrogate_corpus(str(root / "port"), subset="train", **CORPUS)
    ref = j_corpus(str(root / "jax"), subset="train", **CORPUS)
    meta, flac = ours
    write_wav(os.path.join(flac, "LA_train_short.flac"), np.zeros(8000), 16000)  # not a FLAC stream
    write_wav(os.path.join(flac, "LA_train_tiny.wav"), np.zeros(16000), 16000)  # 1 s: too short
    with open(meta, "a") as f:
        f.write("LA_0003 LA_train_short nocodec asvspoof A01 spoof notrim train\n")
    return ours, ref


def test_surrogate_corpus_is_the_jax_packages_byte_for_byte(corpus):
    (meta, flac), (jmeta_path, jflac) = corpus
    with open(jmeta_path, "rb") as f:
        ref_lines = f.read().splitlines()
    with open(meta, "rb") as f:
        assert f.read().splitlines()[: len(ref_lines)] == ref_lines
    names = sorted(os.listdir(jflac))
    assert len(names) == 10
    for name in names:
        with open(os.path.join(flac, name), "rb") as a, open(os.path.join(jflac, name), "rb") as b:
            assert a.read() == b.read(), name


def _write(path, text: str) -> str:
    with open(path, "w") as f:
        f.write(text)
    return str(path)


def test_config_columns_and_loader():
    assert DEFAULT_COLUMNS == J_DEFAULT_COLUMNS
    cfg = loads_config("a:\n  b: ${env:AAD_TEST_UNSET_VAR,fallback}\n")
    assert cfg.a.b == "fallback"


@pytest.mark.parametrize("kind", ["LA", "PA", "DF", "other", "ragged"])
def test_read_metadata_matches_pandas(kind, tmp_path):
    """Schema by column count (DF, PA, LA, else c0..); a line with too many
    fields is skipped, one with too few gets None, blank lines vanish."""
    n = {"LA": 8, "PA": 12, "DF": 10, "other": 3, "ragged": 8}[kind]
    lines = [" ".join(f"v{i}_{j}" for j in range(n)) for i in range(8)]
    if kind == "ragged":  # past the 5 rows pandas previews, where a bad line raises
        lines[5] += " extra"
        lines[6] = " ".join(lines[6].split()[:5])
        lines.insert(7, "   ")
    path = _write(tmp_path / "meta.txt", "\n".join(lines) + "\n")
    assert metadata.detect_columns(path) == jmeta.detect_columns(path)
    with pytest.warns(Warning) if kind == "ragged" else contextlib.nullcontext():
        ref = jmeta.read_metadata(path)
    assert metadata.read_metadata(path) == _records(ref)


def test_prepare_filepaths_and_chunk_rows_match_jax(corpus):
    (meta, flac), _ = corpus
    rows = metadata.prepare_filepaths(metadata.read_metadata(meta), flac)
    ref = jmeta.prepare_filepaths(jmeta.read_metadata(meta), flac)
    assert rows == _records(ref) and len(rows) == 11
    # wrong extension: nothing found
    assert metadata.prepare_filepaths(metadata.read_metadata(meta), flac, extension=".wav") == []
    chunks = dataset.chunk_rows(rows, verbose=False)
    assert chunks == _records(jds.chunk_rows(ref, verbose=False))
    assert len(chunks) == 20 and {r["chunk_index"] for r in chunks} == {0, 1}  # 4.5 s -> two chunks


@pytest.mark.parametrize("case", ["all", "sampled", "balanced", "unbalanceable"])
def test_prepare_dataframe_matches_jax(case, corpus, tmp_path):
    (meta, flac), _ = corpus
    kw = {"all": dict(balance=False, sample_size=None),
          "sampled": dict(balance=False, sample_size=7, seed=5),
          "balanced": dict(balance=True, min_per_class=3, sample_size=None, seed=2),
          "unbalanceable": dict(balance=True, min_per_class=50, sample_size=6)}[case]
    all_data = {"LA": {"metadata": meta, "flac": [flac]}, "missing": {"metadata": str(tmp_path / "no.txt"),
                                                                      "flac": [flac]}}
    os.makedirs(tmp_path / "port")
    os.makedirs(tmp_path / "jax")
    rows = dataset.prepare_dataframe(all_data, rescue_dir=str(tmp_path / "port"), **kw)
    ref = jds.prepare_dataframe(all_data, rescue_dir=str(tmp_path / "jax"), **kw)
    assert rows == _records(ref)
    assert len(rows) == {"all": 20, "sampled": 7, "balanced": 16, "unbalanceable": 6}[case]
    rescue = "LA_ratunkowe.csv"
    pd.testing.assert_frame_equal(pd.read_csv(tmp_path / "port" / rescue, index_col=0),
                                  pd.read_csv(tmp_path / "jax" / rescue, index_col=0))
    # held-out assembly: the train rows' files are excluded, no sampling
    held = dataset.prepare_dataframe(all_data, df_train=rows[:4], rescue_dir=None, **kw)
    jheld = jds.prepare_dataframe(all_data, df_train=ref.iloc[:4], rescue_dir=None, **kw)
    assert held == _records(jheld)


def _labelled(n0: int, n1: int) -> list[dict]:
    return [{"id": i, "label_num": int(i >= n0)} for i in range(n0 + n1)]


@pytest.mark.parametrize("counts", [(7, 3), (3, 7), (5, 5)])
def test_balancers_match_jax(counts):
    rows = _labelled(*counts)
    df = pd.DataFrame(rows)
    for seed in (0, 42):
        assert balance.balance_upsample(rows, seed=seed) == _records(jbal.balance_upsample(df, seed=seed))
        assert balance.balance_downsample(rows, seed=seed) == _records(jbal.balance_downsample(df, seed=seed))
    with pytest.raises(ValueError, match="class 1 has no rows"):
        balance.balance_upsample(_labelled(3, 0))


def test_filtr_nan_and_gmm_bilstm_shape_match_jax(capsys):
    rng = np.random.default_rng(0)
    cells = [rng.standard_normal((19, 6)).astype(np.float32), None, rng.standard_normal((19, 6)), float("nan")]
    rows = [{"id": i, "cqcc": c} for i, c in enumerate(cells)]
    df = pd.DataFrame({"id": range(4), "cqcc": cells})
    assert [r["id"] for r in balance.filtr_nan(rows)] == list(jbal.filtr_nan(df)["id"]) == [0, 2]
    assert "dropped 2 rows with empty cqcc" in capsys.readouterr().out
    ours = prepare_data_gmm_bilstm(rows)
    ref = j_prepare_gmm(df)
    assert [r["id"] for r in ours] == list(ref["id"])
    for r, c in zip(ours, ref["cqcc"]):
        assert r["cqcc"].shape == (6, 19)
        np.testing.assert_array_equal(r["cqcc"], c)


def test_extract_features_cqcc_matches_jax(corpus):
    """CQCC cells from the files, a tail batch padded to ``batch_size``, and
    None for the row whose audio does not decode."""
    (meta, flac), _ = corpus
    rows = dataset.chunk_rows(metadata.prepare_filepaths(metadata.read_metadata(meta), flac), verbose=False)
    rows.append({**rows[0], "file_path": os.path.join(flac, "LA_train_short.flac")})
    ours = pipeline.extract_features(rows, ["cqcc"], batch_size=8, device="cpu")
    ref = jpipe.extract_features(pd.DataFrame(rows), ["cqcc"], batch_size=8)
    assert _strip(ours, ["cqcc"]) == _records(ref, ["cqcc"])
    assert ours[-1]["cqcc"] is None and ref["cqcc"].iloc[-1] is None
    for r, c in zip(ours[:-1], ref["cqcc"].iloc[:-1]):
        assert r["cqcc"].shape == (19, 63)
        np.testing.assert_allclose(r["cqcc"], np.asarray(c), rtol=0, atol=CQCC_TOL)
    pooled, ok = pipeline.extract_feature_array(rows[:3], pipeline.default_extractors()["cqcc"], mean=True,
                                                device="cpu")
    assert pooled.shape == (3, 19) and ok.all()
    np.testing.assert_allclose(pooled, np.stack([r["cqcc"].mean(-1) for r in ours[:3]]), rtol=0, atol=1e-4)


def test_extract_features_refuses_what_is_not_ported(corpus):
    """What both packages refuse: a feature the registry lacks, and
    mfcc_deltas under mean pooling; every registry feature and augmented
    rows run (tests/test_torch_pipeline_features.py holds them to JAX)."""
    (meta, flac), _ = corpus
    rows = metadata.prepare_filepaths(metadata.read_metadata(meta), flac)[:2]
    with pytest.raises(KeyError):
        pipeline.extract_features(rows, ["spectral_flux"], device="cpu")
    with pytest.raises(KeyError):
        jpipe.extract_features(pd.DataFrame(rows), ["spectral_flux"])
    with pytest.raises(ValueError, match="mfcc_deltas"):
        pipeline.extract_features(rows, ["mfcc_deltas"], mean=True, device="cpu")
    assert set(pipeline.default_extractors()) == set(jpipe.default_extractors())
    # no augmentation ("" or None, the JAX package's AUG_NONE codes) and "noise" both run
    for aug in ("", "noise"):
        out = pipeline.extract_features([{**rows[0], "augmentationType": aug}], ["cqcc"], device="cpu")
        assert out[0]["cqcc"].shape == (19, 63)
