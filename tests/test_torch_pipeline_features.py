"""The port's full extraction pipeline and its CLIs against the JAX package's, on the CPU.

``extract_features`` over a few WAVs for every registry feature (pooled and
not, lfcc/gtcc pooled over their time axis), the host ``formants`` cells,
an augmented table (pitch rows held to the JAX package's, noise rows by
their statistics: the two packages draw other noise), ``prepare_dirs_dataset``,
the ``extract`` and ``augment`` CLIs, and ``train-asvspoof --augment`` on a
tiny surrogate corpus. The JAX side gets the same rows as a DataFrame.
"""

import json
import os
import wave

import numpy as np
import pandas as pd
import pytest
import torch

from audioanalysisdetector_tpu.cli.main import main as j_main
from audioanalysisdetector_tpu.data import dataset as jds
from audioanalysisdetector_tpu.data import pipeline as jpipe
from audioanalysisdetector_tpu.data.synthetic import make_surrogate_corpus as j_corpus
from audioanalysisdetector_tpu_torch.cli.main import main as cli_main
from audioanalysisdetector_tpu_torch.data import dataset, pipeline
from audioanalysisdetector_tpu_torch.data.synthetic import make_surrogate_corpus
from audioanalysisdetector_tpu_torch.io.audio import load_audio, write_wav

torch.set_num_threads(2)

SR = 16000
# feature cells, absolute: the per-frontend tolerances of
# tests/test_torch_features.py and test_torch_cqcc.py (fp32 GEMMs in other
# orders through log/dB), plus PEAK_RTOL of the cell's largest value: a
# loud tone's MFCC c0 sums 128 dB values to ~800, and rounds with them
# (reads 1.8e-6 of it); wpt's energies relative
FEATURE_TOL = {"mfcc": 1e-4, "lfcc": 1e-4, "gtcc": 1e-4, "cqcc": 2e-4, "mel_spectrogram": 1e-3,
               "mfcc_deltas": 1e-4}
PEAK_RTOL = 1e-5
WPT_RTOL = 1e-5
# augmented waveforms, relative to the row's peak (tests/test_torch_augment.py's
# vocoder tolerances: the phase cumsum's rounding, larger in the last n_fft samples)
VOCODER_RTOL, VOCODER_TAIL_RTOL, TAIL = 3e-3, 3e-2, 2048
# 16-bit WAVs written from the two packages' pitch variants: one quantum
# (1/32767) on top of the vocoder tolerance in the tail
PCM_TOL = 3e-2


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    """Six WAVs of 2-3 s (noise, a tone, a chirp), one of 1 s, and one file
    that is not audio."""
    d = tmp_path_factory.mktemp("pipe")
    rng = np.random.default_rng(5)
    t = np.arange(3 * SR) / SR
    paths = []
    for i in range(6):
        y = rng.standard_normal(len(t)) * 0.05
        y += 0.3 * np.sin(2 * np.pi * (300 + 200 * i) * t) if i % 2 else 0.2 * np.sin(2 * np.pi * 150 * i * t * t)
        n = 2 * SR if i < 3 else 3 * SR
        paths.append(str(d / f"u{i}.wav"))
        write_wav(paths[-1], np.clip(y[:n], -0.99, 0.99), SR)
    paths.append(str(d / "short.wav"))
    write_wav(paths[-1], rng.standard_normal(SR) * 0.1, SR)
    paths.append(str(d / "broken.wav"))
    with open(paths[-1], "wb") as f:
        f.write(b"not a wav file")
    return d, paths


def _rows(paths, **extra):
    return [{"file_path": p, "chunk_start": 0.0, "chunk_end": 2.0, "label": i % 2, **extra}
            for i, p in enumerate(paths)]


@pytest.mark.parametrize("mean", [False, True])
def test_extract_features_every_feature_matches_jax(wavs, mean):
    _, paths = wavs
    names = ["mfcc", "lfcc", "cqcc", "gtcc", "wpt", "mel_spectrogram"] + ([] if mean else ["mfcc_deltas"])
    rows = _rows(paths)
    ours = pipeline.extract_features(rows, names, batch_size=3, mean=mean, device="cpu")
    ref = jpipe.extract_features(pd.DataFrame(rows), names, batch_size=3, mean=mean)
    assert [r["file_path"] for r in ours] == list(ref["file_path"])
    for name in names:
        for r, c in zip(ours, ref[name]):
            if c is None:
                assert r[name] is None and r["file_path"].endswith("broken.wav")
                continue
            a, c = r[name], np.asarray(c)
            assert a.shape == c.shape, (name, a.shape, c.shape)
            if name == "wpt":
                np.testing.assert_allclose(a, c, rtol=WPT_RTOL, atol=0)
            else:
                np.testing.assert_allclose(a, c, rtol=0, atol=FEATURE_TOL[name] + PEAK_RTOL * np.abs(c).max())
    shapes = {n: ours[0][n].shape for n in names}
    if mean:  # lfcc/gtcc pooled over their time axis (-2): 13 coefficients each
        assert shapes == {"mfcc": (13,), "lfcc": (13,), "cqcc": (19,), "gtcc": (13,), "wpt": (8,),
                          "mel_spectrogram": (64,)}
    else:
        assert shapes["lfcc"] == shapes["gtcc"] == (199, 13) and shapes["mfcc_deltas"] == (39, 63)


def test_formants_cells_match_jax(wavs):
    _, paths = wavs
    rows = _rows(paths[3:])  # two 3-s files, the 1-s file (trimmed, not padded) and the broken one
    rows.append({**rows[0], "chunk_start": 2.98, "chunk_end": 4.98})  # 0.02 s left in the file: too short
    ours = pipeline.extract_features(rows, ["formants"], batch_size=2, device="cpu")
    ref = jpipe.extract_features(pd.DataFrame(rows), ["formants"], batch_size=2)
    for r, c in zip(ours, ref["formants"]):
        if c is None:
            assert r["formants"] is None
            continue
        assert list(r["formants"]) == list(c)
        for k, v in c.items():
            if isinstance(v, int):
                assert r["formants"][k] == v, k
            else:
                assert abs(r["formants"][k] - v) <= 1e-6, (k, r["formants"][k], v)
    assert [r["formants"] is None for r in ours] == [False, False, False, False, True, True]


def _peak_close(ours, ref):
    err = np.abs(ours - ref) / np.abs(ref).max(axis=-1, keepdims=True)
    assert err[..., :-TAIL].max() <= VOCODER_RTOL and err[..., -TAIL:].max() <= VOCODER_TAIL_RTOL


def test_augmented_table_matches_jax(wavs):
    """The identity as the feature shows the augmented waveforms: pitch rows
    against the JAX package's, noise rows by their residual's statistics,
    unaugmented rows (also in an augmented batch) untouched."""
    _, paths = wavs
    base = _rows(paths[:4])
    rows = base + [{**r, "augmentationType": a} for r, a in
                   zip(base, ["change pitch", "noise", "change pitch", "noise"])] + [
        {**base[0], "augmentationType": "nonsense"}]
    identity = {"wav": lambda w: w * 1}
    ours = pipeline.extract_features(rows, identity, batch_size=4, seed=3, device="cpu")
    ref = jpipe.extract_features(pd.DataFrame(rows), {"wav": lambda w: w * 1}, batch_size=4, seed=3)
    clean = np.stack([r["wav"] for r in ours[:4]])
    np.testing.assert_array_equal(clean, np.stack(ref["wav"][:4]))
    np.testing.assert_array_equal(ours[-1]["wav"], clean[0])  # an unknown code is no augmentation
    for i, r in enumerate(ours[4:8]):
        got, want = r["wav"], np.asarray(ref["wav"][4 + i])
        if r["augmentationType"] == "change pitch":
            _peak_close(got[None], want[None])
        else:
            resid = got - clean[i]
            assert abs(resid.std() - 0.005) < 2.5e-4 and abs(resid.mean()) < 2.5e-4
            assert not np.array_equal(got, want)  # other draws than JAX's
    again = pipeline.extract_features(rows, identity, batch_size=4, seed=3, device="cpu")
    assert all(np.array_equal(a["wav"], b["wav"]) for a, b in zip(ours, again))  # one seed, one table


def test_prepare_dirs_dataset_matches_jax(tmp_path):
    rng = np.random.default_rng(2)
    for subset, counts in (("train", {"bonafide": 4, "spoof": 6}), ("val", {"bonafide": 2, "spoof": 2}),
                           ("test", {"real": 1})):
        for label, n in counts.items():
            os.makedirs(tmp_path / "data" / subset / label)
            for i in range(n):
                seconds = (2.0, 4.5, 1.5)[i % 3]  # 1.5 s: too short for a chunk
                write_wav(str(tmp_path / "data" / subset / label / f"{label}{i}.wav"),
                          rng.standard_normal(int(seconds * SR)) * 0.1, SR)
    (tmp_path / "data" / "empty").mkdir()
    (tmp_path / "data" / "notes.txt").write_text("not a subset")
    for kw in ({}, {"min_per_class": {"train": 2, "val": 1, "test": 1}, "sample_size": 5},
               {"balance": False, "sample_size": None}):
        os.makedirs(tmp_path / "port", exist_ok=True)
        os.makedirs(tmp_path / "jax", exist_ok=True)
        ours = dataset.prepare_dirs_dataset(str(tmp_path / "data"), rescue_dir=str(tmp_path / "port"), seed=4, **kw)
        ref = jds.prepare_dirs_dataset(str(tmp_path / "data"), rescue_dir=str(tmp_path / "jax"), seed=4, **kw)
        assert len(ours) == len(ref) == 3
        for rows, df in zip(ours, ref):
            want = [{k: (v.item() if isinstance(v, np.generic) else v) for k, v in r.items()}
                    for r in df.to_dict("records")]
            assert rows == want
        for name in sorted(os.listdir(tmp_path / "jax")):
            assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes(), name


@pytest.mark.parametrize("feature", ["mfcc", "lfcc", "wpt"])
def test_extract_cli_matches_jax(wavs, feature, tmp_path, capsys):
    d, _ = wavs
    argv = ["extract", str(d), "--feature", feature, "--batch-size", "4"]
    assert j_main(argv + ["--output", str(tmp_path / "jax.npz")]) == 0
    assert cli_main(argv + ["--output", str(tmp_path / "port.npz"), "--device", "cpu"]) == 0
    launches = json.loads(capsys.readouterr().err.strip().splitlines()[-1])["kernel_launches"]
    assert set(launches.values()) == {0}  # the CPU runs the plain chain
    with np.load(tmp_path / "jax.npz") as ref, np.load(tmp_path / "port.npz") as ours:
        assert list(ours["files"]) == list(ref["files"]) and len(ours["files"]) == 7  # the broken file dropped
        assert ours["features"].shape == ref["features"].shape
        if feature == "wpt":
            np.testing.assert_allclose(ours["features"], ref["features"], rtol=WPT_RTOL, atol=0)
        else:
            peak = np.abs(ref["features"]).max(axis=(1, 2), keepdims=True)
            assert (np.abs(ours["features"] - ref["features"]) <= FEATURE_TOL[feature] + PEAK_RTOL * peak).all()
    assert cli_main(["extract", str(d), "--feature", "nope", "--device", "cpu"]) == 1


def _pcm(path):
    with wave.open(str(path), "rb") as w:
        assert (w.getnchannels(), w.getsampwidth(), w.getframerate()) == (1, 2, SR)
    return load_audio(str(path), sr=SR)[0]


def test_augment_cli_matches_jax(wavs, tmp_path, capsys):
    d, paths = wavs
    argv = ["augment", str(d), "--seconds", "2", "--pitch-steps", "2", "--noise-factor", "0.01"]
    assert j_main(argv + ["--output-dir", str(tmp_path / "jax")]) == 0
    assert cli_main(argv + ["--output-dir", str(tmp_path / "port"), "--device", "cpu"]) == 0
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names and len(names) == 21  # 7 decodable files x 3
    for p in paths[:-1]:
        stem = os.path.splitext(os.path.basename(p))[0]
        clean = load_audio(p, sr=SR, duration=2.0)[0]
        clean = np.pad(clean, (0, 2 * SR - len(clean)))
        pitch, jpitch = _pcm(tmp_path / "port" / f"{stem}_pitch.wav"), _pcm(tmp_path / "jax" / f"{stem}_pitch.wav")
        err = np.abs(pitch - jpitch) / np.abs(jpitch).max()
        assert err[:-TAIL].max() <= VOCODER_RTOL + 1e-4 and err[-TAIL:].max() <= PCM_TOL
        resid = _pcm(tmp_path / "port" / f"{stem}_noise.wav") - clean
        assert abs(resid.std() - 0.01) < 1e-3
        shifted = _pcm(tmp_path / "port" / f"{stem}_shift.wav")
        # a circular shift of the clip by at most 10% of its length
        assert min(np.abs(np.roll(clean, s) - shifted).max() for s in range(-3200, 3201)) <= 1.0 / 32767


def test_train_asvspoof_augment_matches_jax(tmp_path, capsys):
    """``--augment`` expands the train split by the reference's policy,
    drawn alike in both packages: the same train and eval row counts, the
    same keys, finite EERs (noise rows draw other noise, so the metrics are
    not compared)."""
    corpus = dict(n_bonafide=4, n_spoof_per_tier=2, seconds=4.5, channel="varied")
    tr = make_surrogate_corpus(str(tmp_path / "train"), subset="train", seed=0, **corpus)
    ev = make_surrogate_corpus(str(tmp_path / "eval"), subset="eval", seed=1, **corpus)
    assert j_corpus(str(tmp_path / "jtrain"), subset="train", seed=0, **corpus)[0].endswith(
        os.path.basename(tr[0]))
    argv = ["train-asvspoof", tr[0], ev[0], "--audio-dir", tr[1], ev[1], "--epochs", "1", "--hidden", "8",
            "--gmm-components", "4", "--batch-size", "8", "--gmm-cmvn", "--fusion-weight", "0.5"]
    assert j_main(argv + ["--augment", "--run-dir", str(tmp_path / "jax")]) == 0
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert cli_main(argv + ["--augment", "--run-dir", str(tmp_path / "port"), "--device", "cpu"]) == 0
    ours = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert cli_main(argv + ["--run-dir", str(tmp_path / "plain"), "--device", "cpu"]) == 0
    plain = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(ours) == set(ref) and (ours["n_train"], ours["n_eval"]) == (ref["n_train"], ref["n_eval"])
    assert ours["n_train"] > plain["n_train"] and ours["n_eval"] == plain["n_eval"]
    for arm in ("bilstm", "gmm", "fused"):
        assert 0.0 <= ours[arm]["eer"] <= 1.0
