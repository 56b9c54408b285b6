"""The port's whole slice vs the JAX package, and its HTTP service, on the CPU.

wav -> log-mel -> CNN-BiLSTM -> score through JAX ``make_mel_cnn_bilstm_scorer``
and the port's scorer with the same converted weights; then the port's
``ScoreServer`` answering the ``pcm``, ``pcm_b64``, ``audio_b64`` and
``/v1/score_raw`` lanes.
"""

import base64
import json
import subprocess
import sys
import urllib.error
import urllib.request
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import audioanalysisdetector_tpu.frontend.mel as jmel
from audioanalysisdetector_tpu.models.cnn_bilstm import CNNBiLSTMHybrid as JCNNBiLSTMHybrid
from audioanalysisdetector_tpu.score.e2e import make_mel_cnn_bilstm_scorer as j_make_scorer
from audioanalysisdetector_tpu_torch.cli.main import main as cli_main
from audioanalysisdetector_tpu_torch.convert import flax_to_torch_cnn_bilstm, random_flax_cnn_bilstm
from audioanalysisdetector_tpu_torch.entry import entry
from audioanalysisdetector_tpu_torch.frontend.mel import MelConfig
from audioanalysisdetector_tpu_torch.io.audio import load_audio, write_wav
from audioanalysisdetector_tpu_torch.models.cnn_bilstm import CNNBiLSTMHybrid
from audioanalysisdetector_tpu_torch.score.e2e import init_mel_cnn_bilstm, make_mel_cnn_bilstm_scorer
from audioanalysisdetector_tpu_torch.serve.server import (
    BatchingScorer,
    ScoreServer,
    build_mel_scorer,
    default_bucket_ladder,
)

torch.set_num_threads(2)

# scores after log-mel (fp32 DFT sums in other orders, < 1e-3 dB apart) and
# the model's fp32 layers; the sigmoid's slope is at most 1/4
SCORE_TOL = 1e-5


def _wav(batch: int, seed: int = 0) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal((batch, 32000)) * 0.1).astype(np.float32)


@pytest.mark.parametrize("profile", ["parity", "speech"])
def test_slice_scores_match_jax(profile):
    cfg = MelConfig.for_profile(profile)
    T = 1 + 32000 // cfg.hop_length
    variables = random_flax_cnn_bilstm(0, T)
    model = CNNBiLSTMHybrid(T)
    model.load_state_dict(flax_to_torch_cnn_bilstm(variables))
    wav = _wav(4)
    ours = make_mel_cnn_bilstm_scorer(model, cfg)(torch.from_numpy(wav)).numpy()
    ref = j_make_scorer(JCNNBiLSTMHybrid().apply, variables, jmel.MelConfig.for_profile(profile))(
        jnp.asarray(wav)
    )
    assert ours.shape == (4,)
    np.testing.assert_allclose(ours, np.asarray(ref), rtol=0, atol=SCORE_TOL)
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 is False


@pytest.mark.parametrize("profile", ["parity", "speech"])
def test_bf16_compute_dtype_scores_match_jax(profile):
    """``compute_dtype=bfloat16``: the waveform is rounded to bf16 before
    the mel in both packages. On the CPU both chains then meet the bf16
    samples with f32 bases (JAX's promotion), so the float32 tolerance
    holds; K1's bf16 route on the card (bf16 bases) is held to its plain
    version by chip_smoke.py."""
    cfg = MelConfig.for_profile(profile)
    T = 1 + 32000 // cfg.hop_length
    variables = random_flax_cnn_bilstm(1, T)
    model = CNNBiLSTMHybrid(T)
    model.load_state_dict(flax_to_torch_cnn_bilstm(variables))
    wav = _wav(3, seed=5)
    ours = make_mel_cnn_bilstm_scorer(model, cfg, compute_dtype=torch.bfloat16)(torch.from_numpy(wav)).numpy()
    ref = j_make_scorer(JCNNBiLSTMHybrid().apply, variables, jmel.MelConfig.for_profile(profile),
                        compute_dtype=jnp.bfloat16)(jnp.asarray(wav))
    np.testing.assert_allclose(ours, np.asarray(ref), rtol=0, atol=SCORE_TOL)
    f32 = make_mel_cnn_bilstm_scorer(model, cfg)(torch.from_numpy(wav)).numpy()
    assert np.abs(ours - f32).max() > 0  # the cast took effect


def test_init_is_seeded_and_checkpoint_round_trips(tmp_path):
    cfg = MelConfig.for_speech()
    a = init_mel_cnn_bilstm(cfg, 32000, seed=3, device="cpu")
    b = init_mel_cnn_bilstm(cfg, 32000, seed=3, device="cpu")
    c = init_mel_cnn_bilstm(cfg, 32000, seed=4, device="cpu")
    assert a.conv.in_channels == 126 and not a.training
    for (name, p), q, r in zip(a.state_dict().items(), b.state_dict().values(), c.state_dict().values()):
        assert torch.equal(p, q), name
    assert not torch.equal(a.fc1.weight, c.fc1.weight)
    # a checkpoint without BatchNorm statistics keeps the initial ones
    with torch.no_grad():
        c.bn.running_mean.fill_(0.25)
    state = {k: v for k, v in c.state_dict().items() if not k.startswith("bn.running")}
    path = tmp_path / "model.pt"
    torch.save(state, path)
    loaded = init_mel_cnn_bilstm(cfg, 32000, checkpoint=str(path), seed=3, device="cpu")
    assert torch.equal(loaded.fc1.weight, c.fc1.weight)
    assert torch.equal(loaded.bn.running_mean, a.bn.running_mean)
    torch.save({"conv.weight": c.conv.weight}, path)
    with pytest.raises(ValueError, match="does not fit"):
        init_mel_cnn_bilstm(cfg, 32000, checkpoint=str(path), device="cpu")


def test_entry_scores_on_cpu():
    fn, (wav,) = entry("cpu")
    out = fn(wav)
    assert out.shape == (8,) and torch.isfinite(out).all()


def _post(url, body, headers):
    req = urllib.request.Request(url, data=body, headers=headers, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_server_lanes_match_direct_scorer(tmp_path):
    scorer, n_samples = build_mel_scorer(mel_profile="speech", device="cpu", seed=1)
    assert scorer.row_multiple == 1 and scorer.platform == "cpu"
    batcher = BatchingScorer(scorer, n_samples=n_samples, max_batch=8, bucket_sizes=default_bucket_ladder(8))
    server = ScoreServer(batcher, sr=16000, port=0)
    server.start_background()
    try:
        base = f"http://127.0.0.1:{server.port}"
        rows = _wav(3, seed=2)
        direct = scorer(rows)
        json_hdr = {"Content-Type": "application/json"}

        status, out = _post(f"{base}/v1/score", json.dumps({"pcm": rows[:1].tolist()}).encode(), json_hdr)
        assert status == 200
        np.testing.assert_allclose(out["scores"], direct[:1], rtol=0, atol=SCORE_TOL)
        assert out["labels"] == [int(s > 0.5) for s in out["scores"]]

        b64 = base64.b64encode(rows.astype("<f4").tobytes()).decode()
        status, out = _post(f"{base}/v1/score", json.dumps({"pcm_b64": b64, "rows": 3}).encode(), json_hdr)
        assert status == 200
        np.testing.assert_allclose(out["scores"], direct, rtol=0, atol=SCORE_TOL)

        raw_hdr = {"Content-Type": "application/octet-stream", "X-Rows": "2"}
        status, out = _post(f"{base}/v1/score_raw", rows[1:].astype("<f4").tobytes(), raw_hdr)
        assert status == 200
        np.testing.assert_allclose(out["scores"], direct[1:], rtol=0, atol=SCORE_TOL)

        wav_path = Path(tmp_path) / "row0.wav"
        write_wav(str(wav_path), rows[0], 16000)
        audio = base64.b64encode(wav_path.read_bytes()).decode()
        status, out = _post(f"{base}/v1/score", json.dumps({"audio_b64": audio, "format": "wav"}).encode(), json_hdr)
        assert status == 200  # the io/ decoders are ported: the lane answers
        np.testing.assert_allclose(out["scores"], scorer(load_audio(str(wav_path), sr=16000)[0][None]), rtol=0, atol=SCORE_TOL)
        status, out = _post(f"{base}/v1/score", json.dumps({"audio_b64": audio, "format": "ogg"}).encode(), json_hdr)
        assert status == 400 and "unsupported audio format" in out["error"]

        with urllib.request.urlopen(f"{base}/healthz", timeout=30) as resp:
            health = json.loads(resp.read())
        assert health["platform"] == "cpu" and health["n_samples"] == 32000
    finally:
        server.close()


def test_cli_serve_refuses_what_is_not_ported(capsys):
    assert cli_main(["serve"]) == 2  # no checkpoint and no --allow-random
    assert cli_main(["serve", "--allow-random", "--workers", "2"]) == 2
    assert cli_main(["serve", "--allow-random", "--data-parallel", "on"]) == 2
    assert "not ported" in capsys.readouterr().err


def test_cli_serve_runs_on_cpu():
    """``python -m audioanalysisdetector_tpu_torch serve`` binds, answers
    /healthz, and stops on SIGTERM."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "audioanalysisdetector_tpu_torch", "serve", "--allow-random",
         "--device", "cpu", "--port", "0", "--max-batch", "2", "--mel-profile", "speech"],
        stdout=subprocess.PIPE, text=True, cwd=Path(__file__).resolve().parents[1],
    )
    try:
        info = json.loads(proc.stdout.readline())
        assert info["buckets"] == [1, 2] and info["n_samples"] == 32000
        with urllib.request.urlopen(info["listening"] + "/healthz", timeout=30) as resp:
            assert json.loads(resp.read())["platform"] == "cpu"
    finally:
        proc.terminate()
        proc.wait(timeout=30)
        proc.stdout.close()
