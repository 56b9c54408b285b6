"""The port's ``train-fused`` and ``train-asvspoof`` CLIs against the JAX package's, on the CPU.

Both CLIs run on the same tiny corpora: WAVs in bonafide/spoof directories
for ``train-fused``, the surrogate ASVspoof-layout FLAC corpus (which both
packages write byte for byte) for ``train-asvspoof``. The BiLSTM arm starts
in both from the JAX pipeline's own ``model.init`` with dropout 0 (the
port's ``flax_init_`` replaced by the converted flax weights, as in
``tests/test_torch_train_loop.py``); the GMM arm is trained by each package
from its seeded k-means. The printed JSON must have the same keys and its
numbers must agree.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import audioanalysisdetector_tpu.models.bilstm_classifier as jbc
from audioanalysisdetector_tpu.cli.main import main as j_main
from audioanalysisdetector_tpu.models.bilstm_classifier import BiLSTMClassifier as JBiLSTMClassifier
from audioanalysisdetector_tpu_torch.cli.main import _shuffle
from audioanalysisdetector_tpu_torch.cli.main import main as cli_main
from audioanalysisdetector_tpu_torch.convert import flax_to_torch_bilstm_classifier
from audioanalysisdetector_tpu_torch.data.synthetic import make_surrogate_corpus
from audioanalysisdetector_tpu_torch.io.audio import write_wav
from audioanalysisdetector_tpu_torch.models.bilstm_classifier import BiLSTMClassifier
from audioanalysisdetector_tpu_torch.train import loop

torch.set_num_threads(2)

# every number of the JSON, absolute: the BiLSTM metrics and loss after a
# few Adam steps from the same weights (tests/test_torch_train_loop.py's
# 2e-5 per epoch mean), EERs and accuracies of scores that agree to ~1e-5
# and rank the rows alike, and Platt's (scale, bias) fitted by Newton on
# LLRs of GMMs trained in both packages (fp32 EM in other orders); these
# corpora read 7.6e-6 at most (Platt's bias)
METRIC_TOL = 1e-4
HIDDEN, SR = 8, 16000


class _JNoDropout(JBiLSTMClassifier):
    dropout: float = 0.0


@pytest.fixture
def same_init(monkeypatch):
    """Both pipelines start from the JAX pipeline's init, dropout 0."""
    def init(model, generator):
        seed = int(generator.initial_seed())
        v = _JNoDropout(hidden=HIDDEN).init(jax.random.PRNGKey(seed), jnp.zeros((1, 63, 19)), train=False)
        model.load_state_dict(flax_to_torch_bilstm_classifier(v))
        return model

    monkeypatch.setattr(jbc, "BiLSTMClassifier", _JNoDropout)
    monkeypatch.setattr(loop, "BiLSTMClassifier", functools.partial(BiLSTMClassifier, dropout=0.0))
    monkeypatch.setattr(loop, "flax_init_", init)


def _last_json(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _assert_same_json(ours, ref, path="") -> None:
    if isinstance(ref, dict):
        assert set(ours) == set(ref), path
        for k in ref:
            _assert_same_json(ours[k], ref[k], f"{path}.{k}")
    else:
        assert abs(ours - ref) <= METRIC_TOL, (path, ours, ref)


@pytest.fixture(scope="module")
def wav_dir(tmp_path_factory):
    """20 two-second WAVs (10 bonafide noise, 10 spoof noise + tone), and a
    seed whose 80/20 split holds both classes in the test split."""
    d = tmp_path_factory.mktemp("fused")
    rng = np.random.default_rng(21)
    t = np.arange(2 * SR) / SR
    for label in ("bonafide", "spoof"):
        os.makedirs(d / label)
        for i in range(10):
            y = rng.standard_normal(2 * SR) * 0.05
            if label == "spoof":
                y = y + 0.2 * np.sin(2 * np.pi * rng.uniform(500, 3000) * t)
            write_wav(str(d / label / f"u{i}.wav"), np.clip(y, -0.99, 0.99), SR)
    paths = sorted(str(p) for p in d.rglob("*.wav"))
    seed = next(s for s in range(50) if {"spoof" in p for p in _shuffle(paths, s)[16:]} == {True, False})
    return d, seed


def test_train_fused_matches_jax(wav_dir, same_init, tmp_path, capsys):
    d, seed = wav_dir
    argv = ["train-fused", str(d), "--epochs", "2", "--batch-size", "4", "--hidden", str(HIDDEN),
            "--gmm-components", "4", "--seed", str(seed), "--lr", "1e-3"]
    assert j_main(argv + ["--run-dir", str(tmp_path / "jax")]) == 0
    ref = _last_json(capsys)
    assert cli_main(argv + ["--run-dir", str(tmp_path / "port"), "--device", "cpu"]) == 0
    ours = _last_json(capsys)
    assert set(ref) == {"bilstm", "gmm", "fused"}
    _assert_same_json(ours, ref)
    assert {"scaler.npz", "ubm.npz", "gmm_genuine.npz", "gmm_df.npz", "feature_transform.json"} <= set(
        os.listdir(tmp_path / "port"))


@pytest.fixture(scope="module")
def asvspoof_corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("asvspoof")
    train = make_surrogate_corpus(str(d / "train"), subset="train", n_bonafide=4, n_spoof_per_tier=2,
                                  seconds=4.5, seed=0, channel="varied")
    evals = make_surrogate_corpus(str(d / "eval"), subset="eval", n_bonafide=4, n_spoof_per_tier=2,
                                  seconds=4.5, seed=1, channel="varied")
    return train, evals


@pytest.mark.parametrize("recipe", [
    ["--gmm-cmvn", "--fusion-weight", "0.5"],  # recipe v5's fusion
    ["--gmm-deltas", "--calibrate-llr", "--fusion-weight", "auto", "--map-adapt", "full"],  # v4's, full MAP
])
def test_train_asvspoof_matches_jax(asvspoof_corpus, recipe, same_init, tmp_path, capsys):
    (tr_meta, tr_dir), (ev_meta, ev_dir) = asvspoof_corpus
    argv = ["train-asvspoof", tr_meta, ev_meta, "--audio-dir", tr_dir, ev_dir, "--epochs", "2",
            "--hidden", str(HIDDEN), "--gmm-components", "4", "--batch-size", "8", "--lr", "1e-3", *recipe]
    assert j_main(argv + ["--run-dir", str(tmp_path / "jax")]) == 0
    ref = _last_json(capsys)
    assert cli_main(argv + ["--run-dir", str(tmp_path / "port"), "--device", "cpu"]) == 0
    ours = _last_json(capsys)
    assert set(ref) == {"bilstm", "gmm", "fused", "n_train", "n_eval", "calibration"}
    _assert_same_json(ours, ref)
    # 10 train files x two 2-s chunks, bonafide (8) upsampled to spoof's 12; 20 eval chunks
    assert (ours["n_train"], ours["n_eval"]) == (24, 20)
    assert set(ours["fused"]["per_tier_eer"]) == {"A01", "A02", "A03"}
    assert os.path.exists(tmp_path / "port" / "train_ratunkowe.csv")


def test_train_asvspoof_refuses_augment(asvspoof_corpus, tmp_path, capsys):
    (tr_meta, tr_dir), (ev_meta, ev_dir) = asvspoof_corpus
    rc = cli_main(["train-asvspoof", tr_meta, ev_meta, "--audio-dir", tr_dir, ev_dir, "--augment",
                   "--run-dir", str(tmp_path), "--device", "cpu"])
    assert rc == 2 and "step 11" in capsys.readouterr().err
