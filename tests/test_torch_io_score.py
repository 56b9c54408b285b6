"""The port's ``io/`` copy, streaming scorer, ``score`` CLI and ``audio_b64``
lane vs the JAX package, on the CPU.

The decoders are held bitwise equal to the JAX package's on the same files
(16-bit WAV, a WAV resampled from 8 kHz, FLAC, the native batch loader);
the port's native loader builds into ``build/``, not ``native/``. The
scoring paths are held to the direct scorer on the same decoded rows, with
random weights whose LayerNorm is random too (with the default init the
LayerNorm(1) quirk makes every score equal, and a comparison would show
nothing).
"""

import base64
import glob
import json
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

import audioanalysisdetector_tpu.io.audio as jaudio
import audioanalysisdetector_tpu.io.flac as jflac
import audioanalysisdetector_tpu.io.native_loader as jnative
import audioanalysisdetector_tpu_torch.io.audio as taudio
import audioanalysisdetector_tpu_torch.io.flac as tflac
import audioanalysisdetector_tpu_torch.io.native_loader as tnative
from audioanalysisdetector_tpu_torch.cli.main import main as cli_main
from audioanalysisdetector_tpu_torch.convert import flax_to_torch_cnn_bilstm, random_flax_cnn_bilstm
from audioanalysisdetector_tpu_torch.frontend.mel import MelConfig
from audioanalysisdetector_tpu_torch.score.e2e import init_mel_cnn_bilstm, make_mel_cnn_bilstm_scorer
from audioanalysisdetector_tpu_torch.score.streaming import score_paths, stream_decode_batches
from audioanalysisdetector_tpu_torch.serve.server import (
    BatchingScorer,
    ScoreServer,
    build_mel_scorer,
    default_bucket_ladder,
)

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
# scores of the same rows through two paths of one model on the CPU: other
# batch sizes may block the fp32 matmuls differently
SCORE_TOL = 1e-5


def _pcm(n: int = 32000, seed: int = 0) -> np.ndarray:
    return np.clip(np.random.default_rng(seed).standard_normal(n) * 0.1, -0.999, 0.999)


@pytest.fixture
def corpus(tmp_path):
    """4 WAV + 4 FLAC two-second files at 16 kHz, and one 8 kHz WAV."""
    d = tmp_path / "audio"
    d.mkdir()
    for i in range(4):
        y = _pcm(seed=i)
        jaudio.write_wav(str(d / f"u{i}.wav"), y, 16000)
        jflac.write_flac(str(d / f"v{i}.flac"), np.round(y * 32767).astype(np.int64), 16000)
    jaudio.write_wav(str(d / "low.wav"), _pcm(16000, seed=9), 8000)
    return d


@pytest.fixture
def checkpoint(tmp_path):
    path = tmp_path / "random_cnn_bilstm.pt"
    torch.save(flax_to_torch_cnn_bilstm(random_flax_cnn_bilstm(0, 63)), path)
    return str(path)


def test_decoders_bitwise_equal_to_jax(corpus, tmp_path):
    for name in ("u0.wav", "v1.flac", "low.wav"):
        path = str(corpus / name)
        ours, sr = taudio.load_audio(path, sr=16000)
        ref, jsr = jaudio.load_audio(path, sr=16000)
        assert sr == jsr == 16000 and ours.dtype == ref.dtype == np.float32
        np.testing.assert_array_equal(ours, ref)
        a, b = taudio.audio_info(path), jaudio.audio_info(path)
        assert (a.frames, a.samplerate, a.channels) == (b.frames, b.samplerate, b.channels)
    assert len(taudio.load_audio(str(corpus / "low.wav"), sr=16000)[0]) == 32000  # resampled
    # the writers are the same too, byte for byte
    y = _pcm(seed=5)
    taudio.write_wav(str(tmp_path / "a.wav"), y, 16000)
    jaudio.write_wav(str(tmp_path / "b.wav"), y, 16000)
    x = np.round(y * 32767).astype(np.int64)
    tflac.write_flac(str(tmp_path / "a.flac"), x, 16000)
    jflac.write_flac(str(tmp_path / "b.flac"), x, 16000)
    for ext in ("wav", "flac"):
        assert (tmp_path / f"a.{ext}").read_bytes() == (tmp_path / f"b.{ext}").read_bytes()
    ours, info = tflac.decode_flac(str(tmp_path / "a.flac"))
    np.testing.assert_array_equal(ours, jflac.decode_flac(str(tmp_path / "b.flac"))[0])
    assert info.total_samples == 32000


def test_native_batch_loader_bitwise_and_built_outside_native(corpus):
    tracked = REPO / "native" / "libwavloader.so"
    before = tracked.stat().st_mtime_ns if tracked.exists() else None
    paths = sorted(glob.glob(str(corpus / "*")))
    (corpus / "broken.wav").write_bytes(b"not audio")
    paths.append(str(corpus / "broken.wav"))
    ours, ok = tnative.load_chunk_batch_native(paths, [0.0] * len(paths), [2.0] * len(paths), return_ok=True)
    ref, jok = jnative.load_chunk_batch_native(paths, [0.0] * len(paths), [2.0] * len(paths), return_ok=True)
    np.testing.assert_array_equal(ok, jok)
    assert ok.tolist() == [True] * (len(paths) - 1) + [False]
    np.testing.assert_array_equal(ours[ok], ref[jok])
    assert tnative.native_available()
    lib = tnative._lib_path()
    assert lib.parent == REPO / "build" / "native" and lib.exists()
    if before is not None:  # the JAX package's library was not rebuilt by the port
        assert tracked.stat().st_mtime_ns == before


def test_stream_producer_dies_with_consumer(corpus):
    """Abandoning (or erroring out of) the consumer loop must not leave the
    producer thread parked on a full queue (the JAX package's contract)."""
    paths = sorted(glob.glob(str(corpus / "*.wav"))) * 3
    before = set(threading.enumerate())

    gen = stream_decode_batches(paths, batch_size=2)
    next(gen)
    gen.close()

    def raising_consumer():
        for _ in stream_decode_batches(paths, batch_size=2):
            raise RuntimeError("scorer blew up")

    with pytest.raises(RuntimeError, match="scorer blew up"):
        raising_consumer()

    deadline = time.time() + 10
    while time.time() < deadline:
        leftover = [t for t in threading.enumerate() if t not in before and t.is_alive()]
        if not leftover:
            break
        time.sleep(0.05)
    assert not leftover, f"producer threads leaked: {leftover}"


def test_score_paths_and_cli_match_the_direct_scorer(corpus, checkpoint, capsys):
    cfg = MelConfig()
    model = init_mel_cnn_bilstm(cfg, 32000, checkpoint=checkpoint, device="cpu")
    score = make_mel_cnn_bilstm_scorer(model, cfg)
    paths = sorted(glob.glob(str(corpus / "*")))
    rows = tnative.load_chunk_batch_native(paths, [0.0] * len(paths), [2.0] * len(paths))
    direct = score(torch.from_numpy(rows)).numpy()
    assert np.ptp(direct) > 1e-4  # the weights make the scores differ

    kept, streamed = score_paths(score, paths, device="cpu", batch_size=4)  # ragged tail batch
    assert kept == paths
    np.testing.assert_allclose(streamed, direct, rtol=0, atol=SCORE_TOL)

    assert cli_main(["score", str(corpus), "--checkpoint", checkpoint, "--device", "cpu",
                     "--batch-size", "4"]) == 0
    out, err = capsys.readouterr()
    lines = [json.loads(line) for line in out.strip().splitlines()]
    assert [line["file"] for line in lines] == paths
    got = np.asarray([line["spoof_score"] for line in lines])
    np.testing.assert_allclose(got, direct, rtol=0, atol=SCORE_TOL)
    assert [line["label"] for line in lines] == [int(s > 0.5) for s in got]
    counts = json.loads(err.strip().splitlines()[-1])["kernel_launches"]
    assert counts == {
        "wave_mel": 0, "fused_mel_from_frames": 0, "ct_mel": 0, "ct_mel.reflect": 0,
    }  # CPU: no kernel


def test_cli_score_allow_random_and_refusals(corpus, tmp_path, capsys):
    assert cli_main(["score", str(corpus)]) == 2
    assert "--allow-random" in capsys.readouterr().err
    assert cli_main(["score", str(tmp_path / "empty"), "--allow-random", "--device", "cpu"]) == 1
    assert "no WAV files" in capsys.readouterr().err
    # --allow-random scores with the seed-0 init, as the direct scorer does
    assert cli_main(["score", str(corpus / "*.flac"), "--allow-random", "--device", "cpu"]) == 0
    lines = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
    paths = sorted(glob.glob(str(corpus / "*.flac")))
    assert [line["file"] for line in lines] == paths
    rows = tnative.load_chunk_batch_native(paths, [0.0] * len(paths), [2.0] * len(paths))
    cfg = MelConfig()
    direct = make_mel_cnn_bilstm_scorer(init_mel_cnn_bilstm(cfg, 32000, seed=0, device="cpu"), cfg)(torch.from_numpy(rows))
    np.testing.assert_allclose([line["spoof_score"] for line in lines], direct.numpy(), rtol=0, atol=SCORE_TOL)


def _post(url, body):
    req = urllib.request.Request(url, data=body, headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_audio_b64_lane_matches_pcm_b64(corpus, checkpoint):
    scorer, n_samples = build_mel_scorer(checkpoint=checkpoint, device="cpu")
    batcher = BatchingScorer(scorer, n_samples=n_samples, max_batch=4, bucket_sizes=default_bucket_ladder(4))
    server = ScoreServer(batcher, sr=16000, port=0)
    server.start_background()
    try:
        url = f"http://127.0.0.1:{server.port}/v1/score"
        for name, fmt in (("u0.wav", "wav"), ("v1.flac", "flac"), ("low.wav", "wav")):
            data = (corpus / name).read_bytes()
            status, out = _post(url, json.dumps({"audio_b64": base64.b64encode(data).decode(), "format": fmt}).encode())
            assert status == 200, out
            row = taudio.load_audio(str(corpus / name), sr=16000)[0]
            pcm = base64.b64encode(row.astype("<f4").tobytes()).decode()
            status, ref = _post(url, json.dumps({"pcm_b64": pcm, "rows": 1}).encode())
            assert status == 200
            np.testing.assert_allclose(out["scores"], ref["scores"], rtol=0, atol=SCORE_TOL)
            np.testing.assert_allclose(out["scores"], scorer(row[None]), rtol=0, atol=SCORE_TOL)
        status, out = _post(url, json.dumps({"audio_b64": "AAAA", "format": "mp3"}).encode())
        assert status == 400 and "unsupported audio format" in out["error"]
    finally:
        server.close()
