"""The port's fused GMM ⊕ BiLSTM scorer vs the JAX package, on the CPU.

The same numpy weights (``convert.random_flax_bilstm_classifier``,
``convert.random_diag_gmm``) go into both packages: the BiLSTM classifier,
GMM scoring, both arms, the fused score with its padding and empty-row
rules, calibration and threshold fitting, ``eval_fused`` over a ragged tail,
and the end-to-end ``make_cqcc_fused_scorer`` from raw audio.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audioanalysisdetector_tpu.frontend.cqcc import CQCCConfig as JCQCCConfig
from audioanalysisdetector_tpu.models import gmm as jgmm
from audioanalysisdetector_tpu.models.bilstm_classifier import BiLSTMClassifier as JBiLSTMClassifier
from audioanalysisdetector_tpu.score import fused as jfused
from audioanalysisdetector_tpu.score.e2e import make_cqcc_fused_scorer as j_make_cqcc_fused_scorer
from audioanalysisdetector_tpu.train.gmm_system import make_gmm_feature_fn as j_make_gmm_feature_fn
from audioanalysisdetector_tpu_torch.convert import (
    flax_to_torch_bilstm_classifier,
    random_diag_gmm,
    random_flax_bilstm_classifier,
)
from audioanalysisdetector_tpu_torch.data.scaler import FrameScaler
from audioanalysisdetector_tpu_torch.frontend.cqcc import CQCCConfig
from audioanalysisdetector_tpu_torch.models import gmm as tgmm
from audioanalysisdetector_tpu_torch.models.bilstm_classifier import BiLSTMClassifier
from audioanalysisdetector_tpu_torch.score import fused as tfused
from audioanalysisdetector_tpu_torch.score.e2e import make_cqcc_fused_scorer
from audioanalysisdetector_tpu_torch.train.gmm_system import make_gmm_feature_fn

torch.set_num_threads(2)

# scores and probabilities, port vs JAX: fp32 LSTM, GMM and softmax chains
# summed in other orders (the sigmoid and softmax have slope <= 1/4)
SCORE_TOL = 1e-5
# logits and log-likelihoods (magnitudes up to ~100): fp32 rounding of the
# quadratic expansion's terms, of the same order as in each package alone
LL_TOL = 2e-4
HIDDEN, D = 16, 19


def _classifier(seed: int = 0, input_dim: int = D):
    variables = random_flax_bilstm_classifier(seed, HIDDEN, input_dim)
    model = BiLSTMClassifier(hidden=HIDDEN, input_dim=input_dim)
    model.load_state_dict(flax_to_torch_bilstm_classifier(variables))
    return model.eval(), JBiLSTMClassifier(hidden=HIDDEN).apply, variables


def _gmms(dim: int = D, k: int = 8):
    g, s = random_diag_gmm(1, k, dim), random_diag_gmm(2, k, dim)
    return (tgmm.from_numpy(g, device="cpu"), tgmm.from_numpy(s, device="cpu"),
            jgmm.from_numpy(g), jgmm.from_numpy(s))


def _seqs(batch: int, T: int = 24, seed: int = 0, pad: bool = True) -> np.ndarray:
    """(B, T, D) features; with ``pad`` row 1 ends in zero frames and row 2
    is all padding (an empty sequence)."""
    x = np.random.default_rng(seed).standard_normal((batch, T, D)).astype(np.float32)
    if pad:
        x[1, T - 7 :] = 0.0
        x[2] = 0.0
    return x


def test_bilstm_classifier_matches_jax_with_and_without_lengths():
    model, japply, variables = _classifier()
    x = _seqs(4, pad=False)
    with torch.no_grad():
        ours = model(torch.from_numpy(x)).numpy()
        lengths = np.array([24, 17, 5, 24])
        ours_len = model(torch.from_numpy(x), torch.from_numpy(lengths)).numpy()
        full = model(torch.from_numpy(x), torch.full((4,), 24)).numpy()
    ref = np.asarray(japply(variables, jnp.asarray(x)))
    ref_len = np.asarray(japply(variables, jnp.asarray(x), lengths=jnp.asarray(lengths)))
    assert ours.shape == (4, 2)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=SCORE_TOL)
    np.testing.assert_allclose(ours_len, ref_len, rtol=0, atol=SCORE_TOL)
    # the readout at T-1 of the full sequence is the fixed-length readout
    np.testing.assert_allclose(full, ours, rtol=0, atol=1e-6)
    assert not np.allclose(ours_len[1], ours[1])


def test_gmm_scoring_matches_jax():
    tg, ts, jg, js = _gmms()
    x = _seqs(3)
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    for tf, jf, tol in ((tgmm.component_log_prob, jgmm.component_log_prob, LL_TOL),
                        (tgmm.log_weighted, jgmm.log_weighted, LL_TOL),
                        (tgmm.score_samples, jgmm.score_samples, LL_TOL),
                        (tgmm.score, jgmm.score, LL_TOL),
                        (tgmm.predict_proba, jgmm.predict_proba, SCORE_TOL)):
        np.testing.assert_allclose(tf(tx, tg).numpy(), np.asarray(jf(jx, jg)), rtol=0, atol=tol)
    np.testing.assert_allclose(tgmm.compute_llr(tx, ts, tg).numpy(),
                               np.asarray(jgmm.compute_llr(jx, js, jg)), rtol=0, atol=LL_TOL)
    mask = tfused.padding_mask(tx)
    assert mask.tolist() == np.asarray(jfused.padding_mask(jx)).tolist() and not mask[2].any()
    llr = tgmm.masked_llr(tx, mask, ts, tg).numpy()
    np.testing.assert_allclose(llr, np.asarray(jgmm.masked_llr(jx, jnp.asarray(mask.numpy()), js, jg)),
                               rtol=0, atol=LL_TOL)
    assert llr[2] == 0.0  # an all-padding row
    assert tg.n_components == 8
    back = tgmm.to_numpy(tg)
    assert all(back[k].tobytes() == np.asarray(getattr(jg, k)).tobytes() for k in back)


@pytest.mark.parametrize("transform", ["raw", "deltas_cmvn"])
def test_fused_and_arm_scores_match_jax(transform):
    """Spoof-polarity LLR, 0.5 for the empty row, Platt terms; the GMM arm
    on raw frames or on deltas + CMVN (D = 57 GMMs)."""
    model, japply, variables = _classifier()
    fn_args = dict(deltas=True, cmvn=True) if transform == "deltas_cmvn" else {}
    tg, ts, jg, js = _gmms(3 * D if fn_args else D)
    tfn, jfn = make_gmm_feature_fn(**fn_args), j_make_gmm_feature_fn(**fn_args)
    x = _seqs(4, seed=1)
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    ours = tfused.make_fused_scorer(model, tg, ts, llr_scale=0.3, llr_bias=0.2, gmm_feature_fn=tfn)(tx)
    ref = jfused.make_fused_scorer(japply, variables, jg, js, llr_scale=0.3, llr_bias=0.2,
                                   gmm_feature_fn=jfn)(jx)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0, atol=SCORE_TOL)
    assert float(ours[2]) == 0.5
    arms = tfused.make_arm_scorer(model, tg, ts, gmm_feature_fn=tfn)(tx)
    jarms = jfused.make_arm_scorer(japply, variables, jg, js, gmm_feature_fn=jfn)(jx)
    for a, b, tol in zip(arms, jarms, (SCORE_TOL, LL_TOL, 0)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=tol)
    assert torch.backends.cuda.matmul.allow_tf32 is False and torch.backends.cudnn.allow_tf32 is False


def test_calibration_and_threshold_fitting_match_jax():
    rng = np.random.default_rng(5)
    y = rng.integers(0, 2, 200)
    llrs = rng.standard_normal(200) * 3 + 2 * y
    assert tfused.fit_llr_calibration(llrs, y) == jfused.fit_llr_calibration(llrs, y)
    assert tfused.fit_llr_calibration(np.ones(50), y[:50]) == jfused.fit_llr_calibration(np.ones(50), y[:50])
    scores = 1 / (1 + np.exp(-llrs))
    assert tfused.fit_decision_threshold(scores, y) == jfused.fit_decision_threshold(scores, y)
    assert tfused.fit_decision_threshold(scores, np.zeros(200)) == 0.5


def test_eval_fused_pads_the_ragged_tail_as_jax_does():
    model, japply, variables = _classifier(seed=3)
    tg, ts, jg, js = _gmms()
    x = _seqs(37, seed=2, pad=False)
    y = np.random.default_rng(6).integers(0, 2, 37)
    seen = []

    def scorer(xb):
        seen.append(tuple(xb.shape))
        return tfused.make_fused_scorer(model, tg, ts)(xb)

    ours = tfused.eval_fused(scorer, x, y, batch_size=16, device="cpu")
    ref = jfused.eval_fused(jfused.make_fused_scorer(japply, variables, jg, js), x, y, batch_size=16)
    assert seen == [(16, 24, D)] * 3  # 16 + 16 + 5 rows, the tail padded to 16
    np.testing.assert_array_equal(ours[0], ref[0])
    np.testing.assert_array_equal(ours[1], ref[1])
    assert ours[2]["accuracy"] == ref[2]["accuracy"] and ours[2]["f1"] == ref[2]["f1"]
    assert abs(ours[2]["eer"] - ref[2]["eer"]) <= 1e-6


@pytest.mark.parametrize("scaled", [False, True])
def test_cqcc_fused_scorer_matches_jax(scaled):
    """Raw audio -> CQCC -> (scale) -> fuse, with and without a FrameScaler."""
    model, japply, variables = _classifier(seed=4)
    tg, ts, jg, js = _gmms()
    wav = (np.random.default_rng(9).standard_normal((3, 32000)) * 0.1).astype(np.float32)
    kw = {}
    if scaled:
        rng = np.random.default_rng(10)
        scaler = FrameScaler.fit(rng.standard_normal((500, D)).astype(np.float32) * 20 + 3)
        kw = dict(scaler_mean=scaler.mean, scaler_std=scaler.std)
    ours = make_cqcc_fused_scorer(model, tg, ts, CQCCConfig(), **kw)(torch.from_numpy(wav)).numpy()
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}
    ref = np.asarray(j_make_cqcc_fused_scorer(japply, variables, jg, js, JCQCCConfig(), **jkw)(jnp.asarray(wav)))
    assert ours.shape == (3,) and ((ours > 0) & (ours < 1)).all()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=SCORE_TOL)


def test_cqcc_fused_scorer_refuses_half_a_scaler():
    model, _, _ = _classifier()
    tg, ts, _, _ = _gmms()
    with pytest.raises(ValueError, match="BOTH"):
        make_cqcc_fused_scorer(model, tg, ts, scaler_mean=np.zeros(D, np.float32))
    with pytest.raises(ValueError, match="BOTH"):
        make_cqcc_fused_scorer(model, tg, ts, scaler_std=np.ones(D, np.float32))


def test_frame_scaler_round_trips(tmp_path):
    from audioanalysisdetector_tpu.data.scaler import FrameScaler as JFrameScaler

    seqs = np.random.default_rng(11).standard_normal((4, 10, D)).astype(np.float32)
    seqs[..., 3] = 2.0  # a zero-variance coefficient: sklearn's std 1
    ours, ref = FrameScaler.fit_sequences(seqs), JFrameScaler.fit_sequences(seqs)
    assert ours.mean.tobytes() == ref.mean.tobytes() and ours.std.tobytes() == ref.std.tobytes()
    x = torch.from_numpy(seqs)
    np.testing.assert_allclose(ours.transform(x).numpy(), np.asarray(ref.transform(jnp.asarray(seqs))),
                               rtol=0, atol=SCORE_TOL)
    np.testing.assert_allclose(ours.inverse(ours.transform(x)).numpy(), seqs, rtol=0, atol=1e-5)
    path = str(tmp_path / "scaler.npz")
    ours.save(path)
    loaded = JFrameScaler.load(path)
    assert loaded.mean.tobytes() == ours.mean.tobytes() and FrameScaler.load(path).std.tobytes() == ours.std.tobytes()
