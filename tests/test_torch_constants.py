"""The PyTorch port's host-side constants are bitwise the JAX package's.

The port copies the numpy builders (windows, DFT bases, mel filterbank, the
padded wave_mel operands) instead of importing them, because importing the
JAX package pulls in jax. These tests hold each copy to the original, in
both mel profiles, and check that the port imports without jax.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import audioanalysisdetector_tpu.frontend.mel as jmel
import audioanalysisdetector_tpu.frontend.windows as jwin
from audioanalysisdetector_tpu.frontend.stft import _rdft_bases as j_rdft_bases
from audioanalysisdetector_tpu.frontend.stft import _window_array as j_window_array
from audioanalysisdetector_tpu.frontend.stft import n_frames_for as j_n_frames_for
from audioanalysisdetector_tpu.ops.wave_mel import K_TILE as J_K_TILE
from audioanalysisdetector_tpu.ops.wave_mel import _operands as j_operands
from audioanalysisdetector_tpu_torch.frontend import mel as tmel
from audioanalysisdetector_tpu_torch.frontend import stft as tstft
from audioanalysisdetector_tpu_torch.frontend import windows as twin
from audioanalysisdetector_tpu_torch.ops.wave_mel import K_TILE, _operands, _round_up

torch.set_num_threads(2)

PROFILES = ("parity", "speech")


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["hann", "hamming"])
@pytest.mark.parametrize("n", [1, 400, 512, 2048])
def test_get_window_bitwise(name, n):
    _same(twin.get_window(name, n), jwin.get_window(name, n))
    _same(twin.pad_center(twin.get_window(name, n), 2048), jwin.pad_center(jwin.get_window(name, n), 2048))


@pytest.mark.parametrize("profile", PROFILES)
def test_stft_and_mel_constants_bitwise(profile):
    tcfg = tmel.MelConfig.for_profile(profile)
    jcfg = jmel.MelConfig.for_profile(profile)
    assert (tcfg.n_fft, tcfg.hop_length, tcfg.n_mels) == (jcfg.n_fft, jcfg.hop_length, jcfg.n_mels)
    _same(tstft._window_array("hann", tcfg.n_fft, tcfg.n_fft), j_window_array("hann", jcfg.n_fft, jcfg.n_fft))
    for a, b in zip(tstft._rdft_bases(tcfg.n_fft, "hann", tcfg.n_fft), j_rdft_bases(jcfg.n_fft, "hann", jcfg.n_fft)):
        _same(a, b)
    _same(tcfg.filterbank(), jcfg.filterbank())
    _same(tmel.mel_filterbank(16000.0, tcfg.n_fft, 128), jmel.mel_filterbank(16000.0, jcfg.n_fft, 128))
    assert tstft.n_frames_for(32000, tcfg.hop_length, tcfg.n_fft, True) == j_n_frames_for(
        32000, jcfg.hop_length, jcfg.n_fft, True
    )


@pytest.mark.parametrize("profile", PROFILES)
def test_wave_mel_operands_bitwise(profile):
    tcfg = tmel.MelConfig.for_profile(profile)
    jcfg = jmel.MelConfig.for_profile(profile)
    n_freq = tcfg.n_fft // 2 + 1
    # the port's 64-bin tile and the TPU kernel's 256-bin tile
    for k_pad in {_round_up(n_freq, K_TILE), _round_up(n_freq, J_K_TILE)}:
        for a, b in zip(_operands(tcfg, k_pad), j_operands(jcfg, k_pad)):
            _same(a, b)


def test_port_imports_without_jax():
    """Every module of the port imports with jax, flax, optax, msgpack,
    pandas and yaml blocked (the card machine has none of them), and pulls
    in nothing of the JAX package."""
    code = (
        "import sys\n"
        "for m in ('jax', 'flax', 'optax', 'msgpack', 'pandas', 'yaml'):\n"
        "    sys.modules[m] = None\n"
        "import importlib, pkgutil\n"
        "import audioanalysisdetector_tpu_torch as P\n"
        "for mi in pkgutil.walk_packages(P.__path__, P.__name__ + '.'):\n"
        "    importlib.import_module(mi.name)\n"
        "from audioanalysisdetector_tpu_torch.cli.main import build_parser\n"
        "build_parser().parse_args(['score', '.', '--allow-random'])\n"
        "build_parser().parse_args(['train', '.', '--epochs', '1'])\n"
        "build_parser().parse_args(['train-fused', '.', '--fusion-weight', 'auto'])\n"
        "build_parser().parse_args(['train-asvspoof', 'a', 'b', '--audio-dir', '.', '--gmm-cmvn'])\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'optax', 'msgpack', 'pandas', 'yaml', 'audioanalysisdetector_tpu') "
        "and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
    )
    root = Path(__file__).resolve().parents[1]
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120, cwd=root)
    # and no port module nor the card check names the JAX package in an import
    sources = [*sorted((root / "audioanalysisdetector_tpu_torch").rglob("*.py")), root / "chip_smoke.py"]
    for path in sources:
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]):
                assert not words[1].startswith("audioanalysisdetector_tpu."), (path, line)
                assert words[1] != "audioanalysisdetector_tpu", (path, line)
