"""The port's ``classical`` and ``gridsearch`` CLIs against the JAX package's, on the CPU.

``classical`` runs over the surrogate ASVspoof-layout FLAC corpus (both
packages write it byte for byte) and ``gridsearch`` over WAVs in
bonafide/ and spoof/ directories. The two packages' extractors agree to
~1e-5 of each feature and the estimators to the bounds of
tests/test_torch_ml.py; on these corpora no prediction of any fit moves,
so ``classical``'s JSON is equal (row counts, accuracies, F1, best
parameters) and ``gridsearch``'s two CSVs are equal byte for byte.
"""

import json

import numpy as np
import pytest
import torch

from audioanalysisdetector_tpu.cli.main import main as j_main
from audioanalysisdetector_tpu_torch.cli.main import main as cli_main
from audioanalysisdetector_tpu_torch.data.synthetic import make_surrogate_corpus
from audioanalysisdetector_tpu_torch.io.audio import write_wav

torch.set_num_threads(2)

SR = 16000


@pytest.fixture(scope="module")
def flac_corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("classical_cli")
    return make_surrogate_corpus(str(d / "c"), n_bonafide=16, n_spoof_per_tier=5, seconds=1.0, seed=11,
                                 subset="train")


@pytest.fixture(scope="module")
def wav_dir(tmp_path_factory):
    """16 one-second WAVs: bonafide noise, spoof noise plus a seeded tone."""
    d = tmp_path_factory.mktemp("gridsearch_cli")
    rng = np.random.default_rng(12)
    t = np.arange(SR) / SR
    for i in range(16):
        label = "spoof" if i % 2 else "bonafide"
        y = 0.1 * rng.standard_normal(SR)
        if label == "spoof":
            y += 0.2 * np.sin(2 * np.pi * rng.uniform(300, 3000) * t)
        (d / label).mkdir(exist_ok=True)
        write_wav(str(d / label / f"u{i:02d}.wav"), np.clip(y, -0.999, 0.999).astype(np.float32), SR)
    return d


def _stdout_json(capsys, fn, argv):
    assert fn(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_classical_cli_matches_jax(flac_corpus, tmp_path, capsys):
    meta, flac = flac_corpus
    argv = ["classical", "--dataset", f"LA:{meta}:{flac}", "--seconds", "1.0", "--features", "mfcc,wpt,formants",
            "--components", "4,8"]
    want = _stdout_json(capsys, j_main, argv + ["--cache-dir", str(tmp_path / "j")])
    got = _stdout_json(capsys, cli_main, argv + ["--cache-dir", str(tmp_path / "t"), "--device", "cpu"])
    assert got == want
    assert want["n_train"] > 0 and set(want) == {"svm", "xgb", "n_train", "n_test"}


def test_classical_cli_refuses_without_datasets(capsys):
    assert cli_main(["classical", "--device", "cpu"]) == 2
    assert cli_main(["classical", "--dataset", "LA-only", "--device", "cpu"]) == 2


def test_gridsearch_cli_matches_jax(wav_dir, tmp_path, capsys):
    argv = ["gridsearch", str(wav_dir), "--features", "mfcc", "--components", "4", "--top-k", "3"]
    assert j_main(argv + ["--output-dir", str(tmp_path / "j")]) == 0
    capsys.readouterr()
    assert cli_main(argv + ["--output-dir", str(tmp_path / "t"), "--cache-dir", str(tmp_path / "tc"),
                            "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 3 and json.loads(lines[0])["model"] in ("SVM", "XGB")
    for name in ("gridsearch_summary.csv", "top_5_models.csv"):  # top_k of the CSV is the sweep's 5
        assert (tmp_path / "t" / name).read_text() == (tmp_path / "j" / name).read_text(), name
