"""The port's ``train`` CLI, its checkpoint in both packages, and the mel kernels' grad guard, on the CPU.

``python -m audioanalysisdetector_tpu_torch train <dir> --device cpu`` over
tiny WAVs writes the JAX package's run directory; its ``best_model.msgpack``
scores the same through the port's ``score --checkpoint`` as through the JAX
scorer, and restores into the JAX CLI's own train state. The mel kernels
have no backward: each wrapper refuses, before a launch, an input that
requires grad (``ops.refuse_grad``); on the CPU the plain versions run and
the gradient flows as through the JAX chain.
"""

import inspect
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import audioanalysisdetector_tpu.frontend.mel as jmel
from audioanalysisdetector_tpu.models.cnn_bilstm import CNNBiLSTMHybrid as JCNNBiLSTMHybrid
from audioanalysisdetector_tpu.score.e2e import init_mel_cnn_bilstm as j_init
from audioanalysisdetector_tpu.score.e2e import make_mel_cnn_bilstm_scorer as j_make_scorer
from audioanalysisdetector_tpu.train.checkpoint import restore_checkpoint as j_restore
from audioanalysisdetector_tpu.train.optimizers import make_optimizer as j_make_optimizer
from audioanalysisdetector_tpu.train.state import TrainState as JTrainState
from audioanalysisdetector_tpu_torch.cli.main import _shuffle
from audioanalysisdetector_tpu_torch.cli.main import main as cli_main
from audioanalysisdetector_tpu_torch.frontend.mel import MelConfig, melspectrogram
from audioanalysisdetector_tpu_torch.frontend.stft import center_pad
from audioanalysisdetector_tpu_torch.io.audio import load_audio, write_wav
from audioanalysisdetector_tpu_torch.ops import ct_mel, fused_logmel, launch_counts, refuse_grad, wave_mel

torch.set_num_threads(2)

# scores, port (the same checkpoint, fp32 chains in other orders) vs JAX
SCORE_TOL = 1e-5
# d sum(w * mel) / d wav, port plain chain vs JAX, relative to the largest
# entry: fp32 DFT sums of up to 2048 terms through the backward GEMMs
GRAD_RTOL = 1e-4
SR, SECONDS = 16000, 0.5
N = int(SR * SECONDS)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """10 half-second WAVs (5 bonafide noise, 5 spoof noise + tone), a seed
    whose 80/20 split holds both classes in val, and the CLI's run."""
    d = tmp_path_factory.mktemp("cli_train")
    rng = np.random.default_rng(11)
    t = np.arange(N) / SR
    for label in ("bonafide", "spoof"):
        os.makedirs(d / "audio" / label)
        for i in range(5):
            y = rng.standard_normal(N) * 0.05 + (0.3 * np.sin(2 * np.pi * 1000 * t) if label == "spoof" else 0)
            write_wav(str(d / "audio" / label / f"u{i}.wav"), np.clip(y, -0.99, 0.99), SR)
    paths = sorted(str(p) for p in (d / "audio").rglob("*.wav"))
    seed = next(s for s in range(50) if {"spoof" in p for p in _shuffle(paths, s)[8:]} == {True, False})
    return d, seed


def _run_train(d, seed, capsys) -> tuple[str, dict, dict]:
    run = str(d / f"run{seed}")
    rc = cli_main(["train", str(d / "audio"), "--device", "cpu", "--epochs", "2", "--batch-size", "4",
                   "--seconds", str(SECONDS), "--seed", str(seed), "--run-dir", run])
    assert rc == 0
    out, err = capsys.readouterr()
    metrics = json.loads(out.strip().splitlines()[-1])
    launches = next(json.loads(line)["kernel_launches"] for line in err.splitlines()
                    if line.startswith('{"kernel_launches"'))
    return run, metrics, launches


def test_train_cli_writes_the_run_dir(trained, capsys):
    d, seed = trained
    run, metrics, launches = _run_train(d, seed, capsys)
    assert set(metrics) == {"accuracy", "f1", "eer", "loss"} and np.isfinite(list(metrics.values())).all()
    # every counter of the ledger, in its order, at 0: the CPU runs the plain versions
    assert list(launches.items()) == [(name, 0) for name in launch_counts()]
    assert {"best_model.msgpack", "best_model.msgpack.json", "worst_model.msgpack", "final_model.msgpack",
            "training_log.csv", "training_log.txt", "logs.json", "loss_curve.png",
            "accuracy_curve.png"} <= set(os.listdir(run))
    with open(os.path.join(run, "logs.json")) as f:
        assert [row["epoch"] for row in json.load(f)] == [0, 1]


def test_train_cli_checkpoint_scores_alike_in_both_packages(trained, capsys):
    """The port's ``score --checkpoint best_model.msgpack`` against the JAX
    scorer on the same decoded rows; the file restores into the JAX CLI's
    own train state (``CNNBiLSTMHybrid(logits=True)``, Adam)."""
    d, seed = trained
    run, *_ = _run_train(d, seed, capsys)
    best = os.path.join(run, "best_model.msgpack")
    rc = cli_main(["score", str(d / "audio"), "--checkpoint", best, "--device", "cpu", "--seconds", str(SECONDS)])
    assert rc == 0
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines() if line.strip()]
    assert len(lines) == 10
    rows = np.stack([load_audio(line["file"], sr=SR)[0][:N] for line in lines])
    jcfg = jmel.MelConfig(sr=SR, n_mels=64)
    jmodel, jvars = j_init(jcfg, N, checkpoint=best)
    ref = np.asarray(j_make_scorer(jmodel.apply, jvars, jcfg)(jnp.asarray(rows)))
    np.testing.assert_allclose([line["spoof_score"] for line in lines], ref, rtol=0, atol=SCORE_TOL)

    model = JCNNBiLSTMHybrid(logits=True)
    v = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 1 + N // 512)), train=False)
    template = JTrainState.create(apply_fn=model.apply, params=v["params"], tx=j_make_optimizer("Adam", 1e-4),
                                  batch_stats=v["batch_stats"])
    with open(best + ".json") as f:
        epoch = json.load(f)["epoch"]
    assert int(j_restore(best, template).step) == (epoch + 1) * 2  # 8 train rows at batch 4


def test_refuse_grad_raises_for_an_input_that_requires_grad():
    x = torch.zeros(2, 3, requires_grad=True)
    with pytest.raises(RuntimeError, match=r"no backward.*torch\.no_grad"):
        refuse_grad(x, "ct_mel")
    with torch.no_grad():
        refuse_grad(x, "ct_mel")
    refuse_grad(x.detach(), "ct_mel")


@pytest.mark.parametrize(
    "wrapper", [wave_mel.wave_mel, ct_mel.ct_mel, fused_logmel.fused_mel_from_frames, ct_mel.ct_mel_unpadded]
)
def test_each_wrapper_refuses_grad_before_its_launch(wrapper):
    """The CUDA branch hands the input to ``ops.launch``, which refuses grad
    before it calls the kernel (``tests/test_torch_ops_launch.py``; the
    card's ``chip_smoke.py`` train phase makes it raise there). ``ct_mel``
    and ``ct_mel_unpadded`` reach it through ``ct_mel._launch``."""
    src = inspect.getsource(wrapper)
    call = re.search(r"(?<![\w.])_?launch\(", src)
    assert call is not None and src.index("if not") < call.start()  # after the CPU branch returns
    if call.group().startswith("_"):
        assert re.search(r"(?<![\w.])launch\(", inspect.getsource(ct_mel._launch))


@pytest.mark.parametrize("profile", ["parity", "speech"])
def test_gradient_flows_through_the_plain_mel_on_cpu(profile):
    """On a CPU tensor the plain chain runs and its gradient is the JAX chain's."""
    cfg, jcfg = MelConfig.for_profile(profile), jmel.MelConfig.for_profile(profile)
    rng = np.random.default_rng(3)
    wav = (rng.standard_normal((2, 4000)) * 0.1).astype(np.float32)
    x = torch.from_numpy(wav).requires_grad_()
    mel = melspectrogram(x, cfg)
    w = rng.standard_normal(tuple(mel.shape)).astype(np.float32)
    (mel * torch.from_numpy(w)).sum().backward()
    ref = np.asarray(jax.grad(lambda y: jnp.sum(jmel.melspectrogram(y, jcfg) * w))(jnp.asarray(wav)))
    assert np.isfinite(x.grad.numpy()).all()
    np.testing.assert_allclose(x.grad.numpy(), ref, rtol=0, atol=GRAD_RTOL * np.abs(ref).max())


def test_each_wrapper_keeps_the_gradient_on_cpu():
    cfg = MelConfig.for_profile("parity")
    wav = torch.from_numpy((np.random.default_rng(4).standard_normal((1, 4096)) * 0.1).astype(np.float32))
    for run in (lambda p: ct_mel.ct_mel(p, cfg, n_frames=5), lambda p: wave_mel.wave_mel(p, cfg, n_frames=5),
                lambda p: fused_logmel.fused_mel_from_frames(p[:, :4096].reshape(2, 2048), cfg)):
        padded = center_pad(wav, cfg.n_fft, cfg.pad_mode).contiguous().requires_grad_()
        run(padded).sum().backward()
        assert padded.grad is not None and bool(torch.isfinite(padded.grad).all())
        assert float(padded.grad.abs().max()) > 0
