"""The port's augmentations against the JAX package's, on the CPU.

The deterministic transforms (resampling, the phase-vocoder time stretch and
pitch shift) run on the same numpy-seeded waveforms through both packages.
The random ones draw from a ``torch.Generator`` in the port and a PRNG key
in JAX, so they are held exactly once fed the JAX package's own draws (the
row shifts from ``jax.random.randint``, the noise from
``jax.random.normal``, the mask starts and widths of its key splits), and
by statistics through the generator. ``add_data_augmentation``'s rows are
held to the JAX package's DataFrame record by record.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from audioanalysisdetector_tpu.data import augment as ja
from audioanalysisdetector_tpu.data.balance import add_data_augmentation as j_add_data_augmentation
from audioanalysisdetector_tpu_torch.data import augment as ta
from audioanalysisdetector_tpu_torch.data.balance import add_data_augmentation

torch.set_num_threads(2)

SR = 16000
# resampled waveform, absolute on signals of ~0.5: 16 fp32 taps summed in
# another order, sinc/cos weights of other libms (reads 8.9e-8)
RESAMPLE_TOL = 1e-6
# time stretch / pitch shift, relative to each row's peak: the phase
# vocoder's cumulative phase reaches ~1e4 rad in the top bins (up to 2 pi
# x 256 rad a hop), where one float32 ulp is ~1e-3 rad; XLA's cumsum and
# torch's sequential one round differently there (they read 7.8e-3 rad
# apart on such sums), which moves those bins' phase, and the waveform by
# ~1e-3 of its peak. In the last n_fft samples the iSTFT divides by a
# squared-window sum that falls towards the end of the centre padding, so
# the same rounding grows there (reads 1.5e-2 on a tone)
VOCODER_RTOL = 3e-3
VOCODER_TAIL_RTOL = 3e-2
TAIL = 2048


def _wave(rng, batch, n, scale=0.1):
    return (rng.standard_normal((batch, n)) * scale).astype(np.float32)


def _tone(f0, n=SR, amp=0.5):
    return (amp * np.sin(2 * np.pi * f0 * np.arange(n) / SR)).astype(np.float32)


def _peak_close(ours, ref, rtol=VOCODER_RTOL, tail_rtol=VOCODER_TAIL_RTOL):
    """Within ``rtol`` of each row's peak, ``tail_rtol`` in the last TAIL samples."""
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape
    err = np.abs(ours - ref) / np.abs(ref).max(axis=-1, keepdims=True)
    assert err[..., :-TAIL].max() <= rtol, float(err[..., :-TAIL].max())
    assert err[..., -TAIL:].max() <= tail_rtol, float(err[..., -TAIL:].max())


@pytest.mark.parametrize("n_out", [8000, 15000, 16000, 17321])
def test_resample_to_matches_jax(n_out, rng):
    y = np.concatenate([_wave(rng, 2, SR, 0.3), _tone(440.0)[None]])
    ours = ta.resample_to(torch.from_numpy(y), n_out).numpy()
    np.testing.assert_allclose(ours, np.asarray(ja.resample_to(jnp.asarray(y), n_out)), rtol=0, atol=RESAMPLE_TOL)
    _ = ta._sinc_kernel(8)  # other tap counts build too
    np.testing.assert_allclose(ta.resample_to(torch.from_numpy(y), n_out, taps=8).numpy(),
                               np.asarray(ja.resample_to(jnp.asarray(y), n_out, taps=8)), rtol=0, atol=RESAMPLE_TOL)


@pytest.mark.parametrize("rate", [0.8, 1.25])
def test_time_stretch_matches_jax(rate, rng):
    y = np.concatenate([_wave(rng, 1, SR), _tone(440.0)[None]])
    ours = ta.time_stretch(torch.from_numpy(y), rate)
    assert ours.shape[-1] == int(round(SR / rate))
    _peak_close(ours, ja.time_stretch(jnp.asarray(y), rate))


@pytest.mark.parametrize("n_steps", [0.005, 2.0, -3.0])
def test_pitch_shift_matches_jax(n_steps, rng):
    y = np.concatenate([_wave(rng, 2, SR), _tone(440.0)[None]])
    ours = ta.pitch_shift(torch.from_numpy(y), n_steps=n_steps)
    _peak_close(ours, ja.pitch_shift(jnp.asarray(y), n_steps=n_steps))
    # a near-zero step is the identity, the same tensor
    t = torch.from_numpy(y)
    assert ta.pitch_shift(t, n_steps=1e-12) is t


def test_time_shift_exact_with_jax_draws(rng):
    wav = _wave(rng, 6, 1000, 1.0)
    key = jax.random.PRNGKey(5)
    max_shift = max(int(1000 * 0.2), 1)
    shifts = np.asarray(jax.random.randint(key, (6,), -max_shift, max_shift + 1))
    ref = np.asarray(ja.time_shift(jnp.asarray(wav), key, max_frac=0.2))
    np.testing.assert_array_equal(ta.shift_rows(torch.from_numpy(wav), torch.from_numpy(shifts)).numpy(), ref)
    # leading axes: (2, 3, n) shifts by a (2, 3) draw
    ref3 = np.asarray(ja.time_shift(jnp.asarray(wav.reshape(2, 3, 1000)), key, max_frac=0.2))
    shifts3 = np.asarray(jax.random.randint(key, (2, 3), -max_shift, max_shift + 1))
    ours3 = ta.shift_rows(torch.from_numpy(wav.reshape(2, 3, 1000)), torch.from_numpy(shifts3))
    np.testing.assert_array_equal(ours3.numpy(), ref3)


def test_add_noise_and_selection_exact_with_jax_draws(rng):
    """``augment_rows`` fed the JAX package's noise: noise rows and
    untouched rows bitwise, pitch rows within the vocoder tolerance."""
    wav = _wave(rng, 6, SR)
    codes = np.asarray([ta.AUG_NONE, ta.AUG_PITCH, ta.AUG_NOISE, ta.AUG_NOISE, ta.AUG_NONE, ta.AUG_PITCH], np.int32)
    key = jax.random.PRNGKey(3)
    noise = np.asarray(jax.random.normal(key, wav.shape, jnp.float32))
    ref = np.asarray(ja.apply_augmentations(jnp.asarray(wav), jnp.asarray(codes), key, noise_factor=0.05,
                                            pitch_steps=2.0))
    ours = ta.augment_rows(torch.from_numpy(wav), torch.from_numpy(codes), torch.from_numpy(noise),
                           noise_factor=0.05, pitch_steps=2.0)
    keep = codes != ta.AUG_PITCH
    np.testing.assert_array_equal(ours.numpy()[keep], ref[keep])
    np.testing.assert_array_equal(ours.numpy()[codes == ta.AUG_NONE], wav[codes == ta.AUG_NONE])
    _peak_close(ours[codes == ta.AUG_PITCH], ref[codes == ta.AUG_PITCH])
    np.testing.assert_array_equal(
        (wav + 0.05 * noise)[:1], np.asarray(ja.add_noise(jnp.asarray(wav), key, factor=0.05))[:1])
    # no pitch row: the vocoder is skipped, the rest is the same
    none = np.zeros(6, np.int32)
    assert torch.equal(ta.augment_rows(torch.from_numpy(wav), torch.from_numpy(none), torch.from_numpy(noise)),
                       torch.from_numpy(wav))


def _jax_mask_draws(key, batch, n_masks, max_width, axis_len):
    """The (start, width) pairs ``spec_augment`` draws from one axis's key."""
    out = []
    for _ in range(n_masks):
        key, k1, k2 = jax.random.split(key, 3)
        width = jax.random.randint(k1, (batch,), 0, max_width + 1)
        start = jax.random.randint(k2, (batch,), 0, jnp.maximum(axis_len - width, 1))
        out.append((np.asarray(start), np.asarray(width)))
    return out


@pytest.mark.parametrize("mask_value", [0.0, -1.5])
def test_spec_augment_exact_with_jax_draws(mask_value, rng):
    feat = rng.standard_normal((2, 2, 19, 63)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    kw = dict(n_time_masks=3, n_freq_masks=2, max_time_width=10, max_freq_width=5, mask_value=mask_value)
    ref = np.asarray(ja.spec_augment(jnp.asarray(feat), key, **kw))
    kf, kt = jax.random.split(key)
    flat = torch.from_numpy(feat.reshape(4, 19, 63))
    for start, width in _jax_mask_draws(kf, 4, 2, 5, 19):
        flat = ta.mask_spans(flat, torch.from_numpy(start), torch.from_numpy(width), axis=-2, mask_value=mask_value)
    for start, width in _jax_mask_draws(kt, 4, 3, 10, 63):
        flat = ta.mask_spans(flat, torch.from_numpy(start), torch.from_numpy(width), axis=-1, mask_value=mask_value)
    np.testing.assert_array_equal(flat.reshape(feat.shape).numpy(), ref)
    assert (ref == mask_value).any()


def test_generator_paths_statistics():
    """What the generator draws: noise at the requested level, shifts within
    the range and roughly uniform over it, masks within their widths; one
    seed, one result."""
    g = torch.Generator().manual_seed(0)
    wav = torch.zeros((64, 8000))
    noisy = ta.add_noise(wav, g, factor=0.01)
    assert abs(float(noisy.std()) - 0.01) < 2e-4 and abs(float(noisy.mean())) < 2e-4

    ramp = torch.arange(1000, dtype=torch.float32).repeat(4000, 1)
    out = ta.time_shift(ramp, torch.Generator().manual_seed(1), max_frac=0.1)
    shifts = (out[:, 0].long() * -1) % 1000  # the sample now at 0 came from -shift
    shifts = torch.where(shifts > 500, shifts - 1000, shifts)
    assert int(shifts.min()) == -100 and int(shifts.max()) == 100
    counts = torch.bincount(shifts + 100, minlength=201).float()
    assert float(counts.std() / counts.mean()) < 0.35  # ~0.16 for 4000 uniform draws over 201 values
    for r in (0, 17):
        assert torch.equal(torch.sort(out[r]).values, torch.arange(1000, dtype=torch.float32))

    feat = torch.ones((2000, 19, 63))
    masked = ta.spec_augment(feat, torch.Generator().manual_seed(2), n_time_masks=1, n_freq_masks=0,
                             max_time_width=10)
    widths = (masked == 0).all(dim=1).sum(dim=-1)  # masked frames per map
    assert int(widths.min()) == 0 and int(widths.max()) == 10
    assert abs(float(widths.float().mean()) - 5.0) < 0.3
    cols = (masked == 0).all(dim=1)
    # starts fill [0, len - width), as the JAX package draws them: the first
    # frame is reached, the last never (a quirk of the JAX package's, kept)
    assert bool(cols[:, 0].any()) and bool(cols[:, -2].any()) and not bool(cols[:, -1].any())
    again = ta.spec_augment(feat, torch.Generator().manual_seed(2), n_time_masks=1, n_freq_masks=0,
                            max_time_width=10)
    assert torch.equal(masked, again)


def test_apply_augmentations_per_row_selection(rng):
    wav = torch.from_numpy(_wave(rng, 3, 32000))
    codes = torch.tensor([ta.AUG_NONE, ta.AUG_PITCH, ta.AUG_NOISE])
    out = ta.apply_augmentations(wav, codes, torch.Generator().manual_seed(0), noise_factor=0.05)
    assert torch.equal(out[0], wav[0])
    assert not torch.allclose(out[1], wav[1])
    _peak_close(out[1:2], ja.pitch_shift(jnp.asarray(wav[1:2].numpy())))
    assert abs(float((out[2] - wav[2]).std()) - 0.05) < 2e-3
    fn = ta.make_augmented_feature_fn(lambda w: w.abs().mean(-1), noise_factor=0.05)
    feats = fn(wav, codes, torch.Generator().manual_seed(0))
    torch.testing.assert_close(feats, out.abs().mean(-1), rtol=0, atol=0)


@pytest.mark.parametrize("seed,aug_type", [(0, None), (7, None), (3, ["noise"]), (11, ["a", "b", "c"])])
def test_add_data_augmentation_rows_match_jax(seed, aug_type):
    rows = [{"file_path": f"f{i}.flac", "label": "spoof" if i % 3 else "bonafide", "chunk_index": i % 2,
             "chunk_start": float(i % 2) * 2.0} for i in range(25)]
    ours = add_data_augmentation(rows, aug_type=aug_type, seed=seed)
    ref = j_add_data_augmentation(pd.DataFrame(rows), aug_type=aug_type, seed=seed)
    plain = [{k: (v.item() if isinstance(v, np.generic) else v) for k, v in r.items()}
             for r in ref.to_dict("records")]
    assert ours == plain
    assert len(ours) > len(rows) and all(r["augmentationType"] is None for r in ours[: len(rows)])
    assert rows[0].get("augmentationType", "absent") == "absent"  # the input rows are not changed
