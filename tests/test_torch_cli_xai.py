"""The port's ``xai``, ``train-mfca`` and ``train-3features`` CLIs, on the CPU.

``xai --device cpu`` over a half-second WAV: its heatmaps (caught on their
way to the plot) are the JAX attributions of the same weights (the port's
seed-0 init, converted) on the JAX package's log-mel of the same file, in
the (T, F) orientation, with the occlusion window (1, 5); its PNGs, HTML
page and LIME line are written. ``train-mfca`` and ``train-3features`` write
the run directory, and their checkpoints, restored by the JAX package into
its sweep optimizers' templates and fed the JAX package's features of the
same files, score as the port does on its own features.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from audioanalysisdetector_tpu.frontend.cepstral import CepstralConfig as JCepstralConfig
from audioanalysisdetector_tpu.frontend.cepstral import gfcc as j_gfcc
from audioanalysisdetector_tpu.frontend.cqcc import CQCCConfig as JCQCCConfig
from audioanalysisdetector_tpu.frontend.cqcc import cqcc as j_cqcc
from audioanalysisdetector_tpu.frontend.mel import MelConfig as JMelConfig
from audioanalysisdetector_tpu.frontend.mel import log_mel_spectrogram as j_log_mel
from audioanalysisdetector_tpu.frontend.mfcc import MFCCConfig as JMFCCConfig
from audioanalysisdetector_tpu.frontend.mfcc import mfcc as j_mfcc
from audioanalysisdetector_tpu.models.mobilenet_mfca import MobileNetMFCA as JMobileNetMFCA
from audioanalysisdetector_tpu.models.resnet import AntiSpoofingResNet as JAntiSpoofingResNet
from audioanalysisdetector_tpu.models.resnet import MoreFeaturesClassifier as JMoreFeaturesClassifier
from audioanalysisdetector_tpu.train import checkpoint as jckpt
from audioanalysisdetector_tpu.train.state import TrainState as JTrainState
from audioanalysisdetector_tpu.xai import attribution as jattr
from audioanalysisdetector_tpu_torch import xai
from audioanalysisdetector_tpu_torch.cli.main import main as cli_main
from audioanalysisdetector_tpu_torch.convert import torch_to_flax_resnet
from audioanalysisdetector_tpu_torch.frontend.cepstral import CepstralConfig, gfcc
from audioanalysisdetector_tpu_torch.frontend.cqcc import CQCCConfig, cqcc
from audioanalysisdetector_tpu_torch.frontend.mel import MelConfig, log_mel_spectrogram
from audioanalysisdetector_tpu_torch.frontend.mfcc import MFCCConfig, mfcc
from audioanalysisdetector_tpu_torch.io.audio import write_wav
from audioanalysisdetector_tpu_torch.io.native_loader import load_chunk_batch_native
from audioanalysisdetector_tpu_torch.models.layers import flax_init_
from audioanalysisdetector_tpu_torch.models.mobilenet_mfca import MobileNetMFCA
from audioanalysisdetector_tpu_torch.models.resnet import AntiSpoofingResNet, MoreFeaturesClassifier
from audioanalysisdetector_tpu_torch.train import checkpoint
from audioanalysisdetector_tpu_torch.train.state import TrainState
from audioanalysisdetector_tpu_torch.train.sweep import _sweep_optimizer

torch.set_num_threads(2)

# attribution maps, CLI (port log-mel, plain DFT chain) vs JAX attributions
# on the JAX log-mel of the same file: the features differ by ~1e-4 dB of
# rounding, and the maps are gradients / score drops of fp32 logits; each
# relative to its map's largest entry
MAP_RTOL = 1e-3
# logits of a checkpoint on each package's own features of the same files
SCORE_RTOL = 1e-4
SR, SECONDS = 16000, 0.5
N = int(SR * SECONDS)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """10 half-second WAVs: 5 bonafide noise, 5 spoof noise + tone."""
    d = tmp_path_factory.mktemp("cli_xai")
    rng = np.random.default_rng(31)
    t = np.arange(N) / SR
    for label in ("bonafide", "spoof"):
        os.makedirs(d / "audio" / label)
        for i in range(5):
            y = rng.standard_normal(N) * 0.05 + (0.3 * np.sin(2 * np.pi * 900 * t) if label == "spoof" else 0)
            write_wav(str(d / "audio" / label / f"u{i}.wav"), np.clip(y, -0.99, 0.99), SR)
    paths = sorted(str(p) for p in (d / "audio").rglob("*.wav"))
    wav = load_chunk_batch_native(paths, [0.0] * len(paths), [SECONDS] * len(paths), sr=SR)
    return d, wav


def _launches(err: str) -> dict:
    return next(json.loads(line)["kernel_launches"] for line in err.splitlines()
                if line.startswith('{"kernel_launches"'))


def test_xai_cli_maps_are_the_jax_attributions(corpus, tmp_path, monkeypatch, capsys):
    d, wav = corpus
    caught = {}
    plot = xai.plot_heatmaps

    def catch(heatmaps, out_dir, *, prefix="xai"):
        caught.update(heatmaps)
        return plot(heatmaps, out_dir, prefix=prefix)

    monkeypatch.setattr(xai, "plot_heatmaps", catch)
    out_dir = tmp_path / "xai_out"
    rc = cli_main(["xai", str(d / "audio"), "--device", "cpu", "--seconds", str(SECONDS), "--output-dir",
                   str(out_dir), "--methods", "saliency,gradcam,ig,occlusion,lime", "--ig-steps", "4", "--html"])
    assert rc == 0
    out, err = capsys.readouterr()
    lines = out.strip().splitlines()
    lime = json.loads(lines[0])
    assert set(lime) == {"lime_top_components", "lime_score", "lime_label"} and len(lime["lime_top_components"]) == 5
    assert sorted(os.path.basename(p) for p in lines[1:]) == sorted(
        [f"u0_{k}.png" for k in ("saliency", "grad_cam", "integrated_gradients", "occlusion")]
        + ["gradcam_overlay.png", "explanation.html"])
    assert all(os.path.exists(p) for p in lines[1:])
    assert _launches(err) == {
        "wave_mel": 0, "fused_mel_from_frames": 0, "ct_mel": 0, "ct_mel.reflect": 0,
    }  # the CPU: plain versions

    # the JAX attributions of the CLI's model (flax_init_ from seed 0) on the
    # JAX log-mel of the first file (bonafide/u0.wav)
    model = flax_init_(AntiSpoofingResNet(), torch.Generator().manual_seed(0))
    v = torch_to_flax_resnet(model.state_dict())
    jm = JAntiSpoofingResNet()
    feats = j_log_mel(jnp.asarray(wav[:1]), JMelConfig(sr=SR, n_mels=64))
    ref = jax.jit(lambda v, f: {
        "saliency": jattr.saliency(jm.apply, v, f)[0].T,
        "grad_cam": jattr.grad_cam(jm, v, f, output_size=f.shape[-2:])[0].T,
        "integrated_gradients": jnp.abs(jattr.integrated_gradients(jm.apply, v, f, steps=4)[0]).T,
        "occlusion": jattr.occlusion(jm.apply, v, f, window=(1, 5))[0].T,
    })(v, feats)
    assert set(caught) == set(ref)
    for k, r in ref.items():
        r = np.asarray(r)
        assert caught[k].shape == r.shape == (feats.shape[-1], 64), k
        np.testing.assert_allclose(caught[k], r, rtol=MAP_RTOL, atol=MAP_RTOL * np.abs(r).max(), err_msg=k)
    score = float(jax.nn.softmax(jm.apply(v, feats, train=False), axis=-1)[0, 1])
    assert lime["lime_score"] == pytest.approx(score, rel=SCORE_RTOL)


def _run(argv: list[str], capsys) -> dict:
    assert cli_main(argv) == 0
    out, err = capsys.readouterr()
    assert _launches(err)["ct_mel"] == 0
    return json.loads(out.strip().splitlines()[-1])


def _jax_scores(path: str, jmodel, jtx, feats: tuple) -> np.ndarray:
    v = jax.jit(lambda *f: jmodel.init(jax.random.PRNGKey(0), *f, train=False))(*(f[:1] for f in feats))
    restored = jckpt.restore_checkpoint(path, JTrainState.create(apply_fn=jmodel.apply, params=v["params"], tx=jtx,
                                                                 batch_stats=v["batch_stats"]))
    apply = jax.jit(lambda v, *f: jmodel.apply(v, *f, train=False))
    return np.asarray(apply({"params": restored.params, "batch_stats": restored.batch_stats}, *feats))


def _port_scores(path: str, model, tx, feats: tuple) -> np.ndarray:
    state = checkpoint.restore_checkpoint(path, TrainState.create(model=model, tx=tx))
    with torch.no_grad():
        return state.model.eval()(*feats).numpy()


def test_train_mfca_cli(corpus, tmp_path, capsys):
    d, wav = corpus
    run = tmp_path / "mfca"
    metrics = _run(["train-mfca", str(d / "audio"), "--device", "cpu", "--seconds", str(SECONDS), "--epochs", "1",
                    "--batch-size", "4", "--run-dir", str(run)], capsys)
    assert set(metrics) == {"accuracy", "f1", "eer", "loss"}
    assert {"best_model.msgpack", "final_model.msgpack", "worst_model.msgpack", "metrics.json", "logs.json",
            "training_log.csv", "training_log.txt"} <= set(os.listdir(run))
    path = str(run / "best_model.msgpack")
    with torch.no_grad():
        ours = log_mel_spectrogram(torch.from_numpy(wav), MelConfig(sr=SR, n_mels=64))
    ref = _jax_scores(path, JMobileNetMFCA(), optax.chain(optax.add_decayed_weights(1e-5), optax.adam(1e-4)),
                      (j_log_mel(jnp.asarray(wav), JMelConfig(sr=SR, n_mels=64)),))
    got = _port_scores(path, MobileNetMFCA(), _sweep_optimizer("Adam", 1e-4), (ours,))
    np.testing.assert_allclose(got, ref, rtol=SCORE_RTOL, atol=SCORE_RTOL * np.abs(ref).max())


def test_train_3features_cli(corpus, tmp_path, capsys):
    d, wav = corpus
    run = tmp_path / "three"
    metrics = _run(["train-3features", str(d / "audio"), "--device", "cpu", "--seconds", str(SECONDS), "--epochs",
                    "1", "--batch-size", "4", "--run-dir", str(run)], capsys)
    assert set(metrics) == {"accuracy", "f1", "eer", "loss"}
    path = str(run / "final_model.msgpack")
    w = torch.from_numpy(wav)
    with torch.no_grad():
        ours = (cqcc(w, CQCCConfig.for_sr(SR)), gfcc(w, CepstralConfig(fs=SR, nfilts=40, fb_kind="gammatone")),
                mfcc(w, MFCCConfig.for_sr(SR)))
    jw = jnp.asarray(wav)
    jfeats = (j_cqcc(jw, JCQCCConfig.for_sr(SR)), j_gfcc(jw, JCepstralConfig(fs=SR, nfilts=40, fb_kind="gammatone")),
              j_mfcc(jw, JMFCCConfig.for_sr(SR)))
    assert [tuple(f.shape) for f in ours] == [tuple(f.shape) for f in jfeats]
    ref = _jax_scores(path, JMoreFeaturesClassifier(), optax.adam(1e-4), jfeats)
    got = _port_scores(path, MoreFeaturesClassifier(), torch.optim.Adam, ours)
    np.testing.assert_allclose(got, ref, rtol=SCORE_RTOL, atol=SCORE_RTOL * np.abs(ref).max())


def test_slice_runs_without_sklearn_or_matplotlib():
    """The card machine has neither: with both blocked (and jax, flax,
    optax, msgpack, pandas, yaml), the slice's modules import, the new
    commands parse, LIME's surrogate fits and the plots skip."""
    code = (
        "import sys\n"
        "for m in ('jax', 'flax', 'optax', 'msgpack', 'pandas', 'yaml', 'sklearn', 'matplotlib'):\n"
        "    sys.modules[m] = None\n"
        "import numpy as np, torch\n"
        "from audioanalysisdetector_tpu_torch import xai\n"
        "from audioanalysisdetector_tpu_torch.train import sweep\n"
        "from audioanalysisdetector_tpu_torch.cli.main import build_parser\n"
        "build_parser().parse_args(['xai', '.', '--methods', 'lime', '--html'])\n"
        "build_parser().parse_args(['train-mfca', '.', '--epochs', '1'])\n"
        "build_parser().parse_args(['train-3features', '.', '--epochs', '1'])\n"
        "out = xai.lime_single_instance(lambda b: b.mean(dim=(-1, -2)), np.ones((19, 20), np.float32),\n"
        "                               n_perturbations=8)\n"
        "assert out['coefficients'].shape == (19,)\n"
        "assert xai.plot_heatmaps({'a': np.ones((3, 3))}, '.') == []\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'sklearn', 'matplotlib', "
        "'audioanalysisdetector_tpu') and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                          cwd=Path(__file__).resolve().parents[1])
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stderr.count("matplotlib is not installed") == 1
