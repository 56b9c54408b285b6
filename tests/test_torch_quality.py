"""The port's quality lane: recipe v5 over the five disjoint seed pairs, held to a band around the JAX package's.

``run_multiseed_quality(recipe=RECIPE_V5)`` on the card runs the flagship
``train-asvspoof`` recipe five times (the surrogate corpus, which both
packages write byte for byte, at full v5 size). The port's BiLSTM starts
from ``flax_init_`` on a torch generator, other draws than the JAX
package's, so only agreement within seed jitter can be asked of it; its GMM
arm sees the same frames and the same seeded EM up to fp32. The band, set
before the port's first run, around ``QUALITY_r05.json``'s
``multiseed_v5`` means (fused 0.2531, BiLSTM 0.2638, GMM-CMVN 0.2596; fusion
won on 5 of 5 pairs):

- each arm's mean EER within ``ARM_BAND`` of the JAX package's;
- the fused mean no worse than the BiLSTM mean;
- fusion winning on at least ``MIN_WIN_RATE`` of the pairs.

The slow test runs the lane where there is a card (the JAX side of this
suite must import too). On the card machine, which has no jax, the same
lane runs as ``python -m audioanalysisdetector_tpu_torch.train.quality
<workdir> --out QUALITY_torch_v5.json``, and the result it wrote is held to
the band below.
"""

import json
import os

import pytest
import torch

from audioanalysisdetector_tpu_torch.train.quality import RECIPE_V5, SEED_PAIRS, run_multiseed_quality

ROOT = os.path.join(os.path.dirname(__file__), "..")
# mean EER over the five pairs, port against the JAX package: the pairs'
# spread in QUALITY_r05.json is 0.011-0.016 (std), so a mean of five draws
# of a new BiLSTM init moves ~0.007 by jitter alone; 0.03 leaves room for
# the init's other distribution. The GMM arm trains on the same frames
# with the same seeded EM, so its band is narrower.
ARM_BAND = {"fused": 0.03, "bilstm": 0.03, "gmm": 0.02}
MIN_WIN_RATE = 0.6


def _jax_means() -> dict:
    with open(os.path.join(ROOT, "QUALITY_r05.json")) as f:
        agg = json.load(f)["multiseed_v5"]["aggregate"]
    return {arm: agg[arm]["mean_eer"] for arm in ARM_BAND}


def _assert_in_band(result: dict) -> None:
    assert result["recipe_version"] == 5 and result["n_seed_pairs"] == len(SEED_PAIRS)
    assert [s["seeds"] for s in result["per_seed"]] == [list(p) for p in SEED_PAIRS]
    ref = _jax_means()
    means = {arm: result["aggregate"][arm]["mean_eer"] for arm in ARM_BAND}
    for arm, band in ARM_BAND.items():
        assert abs(means[arm] - ref[arm]) <= band, (arm, means[arm], ref[arm])
    assert means["fused"] <= means["bilstm"], means
    assert result["fused_win_rate"] >= MIN_WIN_RATE, result["fused_win_rate"]
    for s in result["per_seed"]:
        assert set(s["per_tier_eer"]) == {"A01", "A02", "A03"}


def test_recorded_port_quality_within_band():
    """The lane's run on the card (``QUALITY_torch_v5.json``, written by the
    module command above) holds the band."""
    with open(os.path.join(ROOT, "QUALITY_torch_v5.json")) as f:
        result = json.load(f)
    assert result["device"].startswith("NVIDIA")
    _assert_in_band(result)


@pytest.mark.slow
@pytest.mark.cuda
def test_multiseed_v5_within_band(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("the quality lane runs the port on a CUDA card; none here")
    _assert_in_band(run_multiseed_quality(str(tmp_path), recipe=RECIPE_V5, device="cuda"))
