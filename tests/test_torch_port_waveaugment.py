"""PyTorch port: WaveAugment (``ops/waveaugment.py``) against the JAX package, on the CPU.

Every transform and the whole chain take their draws as data: the test
recomputes with ``jax.random`` the draws the JAX function takes from its
key, on the same split tree (``_torch_port_helpers.jax_chain_draws``), and
hands them to the port. 1-s rows (L = 16 000) of seeded noise plus a tone.
The JAX functions run eagerly, op by op, as written: under ``jax.jit`` XLA
contracts the resample's position arithmetic (6.5e-6 off its own eager
result on these rows), which the port does not copy.

Tolerances (float32 on both sides; observed worst cases in brackets):

* gather and elementwise transforms (gain, time inversion, shift, the
  resamples of pitch shift and time stretch, splice-out, time masking):
  1e-6 absolute on rows of amplitude ~1 [0: equal to the bit];
* FFT-based transforms (the filters, coloured noise, the fused group):
  each row within 1e-5 of the RMS of the row that went in [1.5e-6];
* the phase-vocoder pitch shift on tones: relative RMS error 5e-3
  [9.6e-4]. Its phase accumulator reaches ~6e4 rad at the top bins, where
  float32's spacing is 4e-3 rad, and the two packages sum it in another
  order; near-zero bins' angles are ill-conditioned, so it is held on
  tones only;
* the whole chain: 1e-5 of the input row's RMS [default 1.5e-6,
  fuse_lowpass 1.2e-6], and 5e-3 relative RMS with ``"pv"`` on tones
  [5.6e-4].

The port's own draws are checked by distribution: the per-row application
rate against p (binomial) and the uniform draws' bounds and histogram
(chi-square), as ``tests/test_data.py`` checks the JAX sampler.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from _torch_port_helpers import (
    jax_chain_draws, jd_bandstop, jd_cut, jd_gain, jd_inversion, jd_noise, jd_pitch, jd_shift, jd_splice,
    jd_stretch, jd_timemask, torch_chain,
)
from audio_few_shot_learning_tpu import config as jcfg
from audio_few_shot_learning_tpu.ops import waveaugment as jw
from audio_few_shot_learning_tpu_torch import config as tcfg
from audio_few_shot_learning_tpu_torch.ops import waveaugment as tw

SR, L, B = 16000, 16000, 6
EXACT_ATOL, FFT_RMS, PV_REL = 1e-6, 1e-5, 5e-3
DATASET = "ESC-50-master"


def _signal(seed, b=B, freqs=(440.0,)):
    rng = np.random.default_rng(seed)
    t = np.arange(L) / SR
    tone = sum(np.sin(2 * np.pi * f * t + rng.uniform(0, 6)) for f in freqs)
    return (0.5 * tone[None] / len(freqs) + 0.2 * rng.standard_normal((b, L))).astype(np.float32)


def _tones(seed, b=3):
    rng = np.random.default_rng(seed)
    t = np.arange(L) / SR
    f0 = rng.uniform(200.0, 1200.0, b)[:, None]
    return (0.6 * np.sin(2 * np.pi * f0 * t) + 0.2 * np.sin(4 * np.pi * f0 * t + 1.0)).astype(np.float32)


def _t(d):
    return torch_chain({"_": d})["_"]


# (JAX call on (x, key), its draws from (key, b), the port's call on (x, draws), tolerance kind)
CASES = {
    "lowpass": (lambda x, k: jw.lowpass(x, k, 1191.0, 2000.0, 0.6),
                lambda k, b: jd_cut(k, b, 1191.0, 2000.0, 0.6),
                lambda x, d: tw.lowpass(x, d), "fft"),
    "highpass": (lambda x, k: jw.highpass(x, k, 350.0, 1191.0, 0.6),
                 lambda k, b: jd_cut(k, b, 350.0, 1191.0, 0.6),
                 lambda x, d: tw.highpass(x, d), "fft"),
    "bandstop": (lambda x, k: jw.bandstop(x, k, 350.0, 1191.0, 0.5, 1.0, 0.6),
                 lambda k, b: jd_bandstop(k, b, 350.0, 1191.0, 0.5, 1.0, 0.6),
                 lambda x, d: tw.bandstop(x, d), "fft"),
    "highpass_bandstop": (
        lambda x, k: jw.highpass_bandstop(x, *jax.random.split(k), 350.0, 1191.0, 350.0, 1191.0, 0.5, 1.0, 0.5, 0.6),
        lambda k, b: {"hp": jd_cut(jax.random.split(k)[0], b, 350.0, 1191.0, 0.5),
                      "bs": jd_bandstop(jax.random.split(k)[1], b, 350.0, 1191.0, 0.5, 1.0, 0.6)},
        lambda x, d: tw.highpass_bandstop(x, d["hp"], d["bs"]), "fft"),
    "gain": (lambda x, k: jw.gain(x, k, -6.0, 6.0, 0.6), lambda k, b: jd_gain(k, b, -6.0, 6.0, 0.6),
             lambda x, d: tw.gain(x, d), "exact"),
    "time_inversion": (lambda x, k: jw.time_inversion(x, k, 0.5), lambda k, b: jd_inversion(k, b, 0.5),
                       lambda x, d: tw.time_inversion(x, d), "exact"),
    # negative fractions: truncation toward zero, then a floor modulo
    "shift": (lambda x, k: jw.shift(x, k, -0.5, 0.5, 0.8), lambda k, b: jd_shift(k, b, -0.5, 0.5, 0.8),
              lambda x, d: tw.shift(x, d), "exact"),
    "add_colored_noise": (
        lambda x, k: jw.add_colored_noise(x, k, 10.0, 21.4, -2.0, 2.0, 0.7),
        lambda k, b: jd_noise(k, b, L, 10.0, 21.4, -2.0, 2.0, 0.7, spectrum=False),
        lambda x, d: tw.add_colored_noise(x, d), "fft"),
    "noise_highpass_bandstop": (
        lambda x, k: jw.noise_highpass_bandstop(
            x, *jax.random.split(k, 4)[:3], 10.0, 21.4, -2.0, 2.0, 350.0, 1191.0, 350.0, 1191.0, 0.5, 1.0,
            0.6, 0.5, 0.6, key_lp=jax.random.split(k, 4)[3], lp_min_cut=1191.0, lp_max_cut=2000.0, p_lp=0.5),
        lambda k, b: dict(zip(("noise", "hp", "bs", "lp"), (
            jd_noise(jax.random.split(k, 4)[0], b, L, 10.0, 21.4, -2.0, 2.0, 0.6, spectrum=True),
            jd_cut(jax.random.split(k, 4)[1], b, 350.0, 1191.0, 0.5),
            jd_bandstop(jax.random.split(k, 4)[2], b, 350.0, 1191.0, 0.5, 1.0, 0.6),
            jd_cut(jax.random.split(k, 4)[3], b, 1191.0, 2000.0, 0.5)))),
        lambda x, d: tw.noise_highpass_bandstop(x, d["noise"], d["hp"], d["bs"], d_lp=d["lp"]), "fft"),
    # a member of probability 0 is left out of the fused group
    "noise_bandstop": (
        lambda x, k: jw.noise_highpass_bandstop(
            x, *jax.random.split(k, 3), 10.0, 21.4, -2.0, 2.0, 350.0, 1191.0, 350.0, 1191.0, 0.5, 1.0,
            0.6, 0.0, 0.6),
        lambda k, b: {"noise": jd_noise(jax.random.split(k, 3)[0], b, L, 10.0, 21.4, -2.0, 2.0, 0.6, spectrum=True),
                      "bs": jd_bandstop(jax.random.split(k, 3)[2], b, 350.0, 1191.0, 0.5, 1.0, 0.6)},
        lambda x, d: tw.noise_highpass_bandstop(x, d["noise"], None, d["bs"]), "fft"),
    "pitch_shift": (lambda x, k: jw.pitch_shift(x, k, -4, 4, 0.7), lambda k, b: jd_pitch(k, b, -4, 4, 0.7),
                    lambda x, d: tw.pitch_shift(x, d, -4, 4), "exact"),
    "time_stretch": (lambda x, k: jw.time_stretch(x, k, 0.9, 1.1, 0.7), lambda k, b: jd_stretch(k, b, 0.9, 1.1, 0.7),
                     lambda x, d: tw.time_stretch(x, d, 0.9, 1.1), "exact"),
    "splice_out": (lambda x, k: jw.splice_out(x, k, 8, 400, 0.8), lambda k, b: jd_splice(k, b, L, 8, 400, 0.8),
                   lambda x, d: tw.splice_out(x, d, 8, 400), "exact"),
    "time_masking": (lambda x, k: jw.time_masking(x, k, 5, 0.01, 0.8),
                     lambda k, b: jd_timemask(k, b, L, 5, 0.01, 0.8),
                     lambda x, d: tw.time_masking(x, d, 5, 0.01), "exact"),
}


def _hold(got, want, kind, x):
    """``x``: the rows that went in, whose RMS scales an FFT's rounding (an
    output row can be near silent after a band-stop or the masks)."""
    if kind == "exact":
        np.testing.assert_allclose(got, want, atol=EXACT_ATOL, rtol=0)
    else:
        rms = np.sqrt(np.mean(x.astype(np.float64) ** 2, axis=-1))
        err = np.abs(got - want).max(axis=-1)
        assert (err <= FFT_RMS * rms).all(), (err / rms).max()


@pytest.mark.parametrize("name", sorted(CASES))
def test_transform_matches_jax(name):
    jax_fn, jax_draws, port_fn, kind = CASES[name]
    x = _signal(sorted(CASES).index(name))
    key = jax.random.PRNGKey(7)
    want = np.asarray(jax_fn(jnp.asarray(x), key))
    d = jax_draws(key, B)
    d = torch_chain(d) if isinstance(next(iter(d.values())), dict) else _t(d)
    got = port_fn(torch.from_numpy(x), d).numpy()
    assert got.shape == want.shape == (B, L) and got.dtype == np.float32
    _hold(got, want, kind, x)
    assert not np.array_equal(got, x), "the draws applied nothing"


@pytest.mark.parametrize("out_len,rates", [(L, (1.26, 0.79, 1.0, 1e-4)), (L // 2 + 5, (1.5, 0.5, 1.1, 0.9))])
def test_resample_positions_match_jax(out_len, rates):
    """The blocked float32 positions at the rate bound, at a rate under the
    1e-3 clip and to another length: both packages agree sample for sample."""
    x = _signal(3, b=len(rates))
    r = np.asarray(rates, np.float32)
    max_rate = 1.26 if out_len == L else 1.5
    want = np.asarray(jw._resample_to_length(jnp.asarray(x), jnp.asarray(r), out_len, max_rate))
    got = tw._resample_to_length(torch.from_numpy(x), torch.from_numpy(r), out_len, max_rate).numpy()
    np.testing.assert_allclose(got, want, atol=EXACT_ATOL, rtol=0)


def _rel_rms(got, want):
    return np.sqrt(np.mean((got - want) ** 2, axis=-1) / np.mean(want**2, axis=-1))


def test_pitch_shift_pv_matches_jax_on_tones():
    x = _tones(4, b=B)
    key = jax.random.PRNGKey(9)
    want = np.asarray(jw.pitch_shift_pv(jnp.asarray(x), key, -4, 4, 1.0))
    got = tw.pitch_shift_pv(torch.from_numpy(x), _t(jd_pitch(key, B, -4, 4, 1.0)), -4, 4).numpy()
    assert (_rel_rms(got, want) <= PV_REL).all(), _rel_rms(got, want)


# aug_num x items = B rows, the transform tests' shape: JAX's eager ops compile once per shape
CHAINS = {
    "default": {"use": True, "aug_num": 3},
    "fuse_lowpass": {"use": True, "aug_num": 2, "fuse_lowpass": True, "timestretch_p": 0.7,
                     "timeinversion_p": 0.5},
    "pv": {"use": True, "aug_num": 2, "pitchshift_mode": "pv", "pitchshift_p": 1.0},
}


@pytest.mark.parametrize("name", sorted(CHAINS))
def test_chain_matches_jax(name):
    """``WaveAugment.__call__`` ``[B, L] -> [B, 1 + n, L]``: the draws of
    JAX ``apply_once`` on the copy-major ``[n x B]`` rows, from its key."""
    raw = CHAINS[name]
    n = raw["aug_num"]
    b = B // n
    x = _tones(5, b=b) if name == "pv" else _signal(5, b=b)
    key = jax.random.PRNGKey(11)
    jaug = jw.WaveAugment(jcfg.WaveAugParams.from_dict(raw), dataset_name=DATASET)
    want = np.asarray(jaug(jnp.asarray(x), key))
    draws = jax_chain_draws(raw, DATASET, key, n * b, L)
    draws = {nm: {k: v.reshape(n, b, *v.shape[1:]) for k, v in d.items()} for nm, d in draws.items()}
    aug = tw.WaveAugment(tcfg.WaveAugParams.from_dict(raw), dataset_name=DATASET)
    got = aug(torch.from_numpy(x), draws=torch_chain(draws)).numpy()
    assert got.shape == want.shape == (b, 1 + n, L) and aug.num_views == 1 + n
    np.testing.assert_array_equal(got[:, 0], x)
    if name == "pv":
        rel = _rel_rms(got[:, 1:].reshape(-1, L), want[:, 1:].reshape(-1, L))
        assert (rel <= PV_REL).all(), rel
    else:
        _hold(got.reshape(-1, L), want.reshape(-1, L), "fft", np.repeat(x, 1 + n, axis=0))


@pytest.mark.parametrize("raw,names,noise_kind", [
    ({"use": True}, {"lowpass", "pitchshift", "shift", "gain", "noise", "highpass", "bandstop",
                     "spliceout", "timemasking"}, "w"),
    ({"use": True, "highpass_p": 0.0, "bandstop_p": 0.0, "pitchshift_p": 0.0},
     {"lowpass", "shift", "gain", "noise", "spliceout", "timemasking"}, "white"),
    ({"use": True, "noise_p": 0.0, "bandstop_p": 0.0, "lowpass_p": 0.0, "gain_p": 0, "shift_p": 0,
      "pitchshift_p": 0, "spliceout_p": 0, "timemasking_p": 0}, {"highpass"}, None),
])
def test_static_structure(raw, names, noise_kind):
    """A transform of probability 0 draws nothing and is skipped; noise,
    high-pass and band-stop fuse (the noise drawn in the spectrum) when two
    or more are on, else noise runs alone on time-domain white noise."""
    aug = tw.WaveAugment(tcfg.WaveAugParams.from_dict(raw), dataset_name=DATASET)
    d = aug.draw(torch.Generator().manual_seed(0), (1, 3, 2), 4096, "cpu")  # [E, aug_num, B]
    assert set(d) == names
    if noise_kind:
        assert noise_kind in d["noise"]
    assert all(v.shape[:3] == (1, 3, 2) for dd in d.values() for v in dd.values())
    x = torch.from_numpy(_signal(1, b=2)[:, :4096])
    assert aug(x[None], draws=d).shape == (1, 2, 4, 4096)


def test_own_draws_by_distribution():
    """Draws of the port's own generator: each transform's application rate
    against its p (binomial), every uniform within its bounds and flat
    (chi-square over 10 bins), integer starts and widths in range."""
    raw = {"use": True, "fuse_lowpass": True, "timeinversion_p": 0.25, "timestretch_p": 0.4}
    aug = tw.WaveAugment(tcfg.WaveAugParams.from_dict(raw), dataset_name=DATASET)
    rows, length = 4000, 2048
    d = {k: {kk: vv.numpy() for kk, vv in v.items()} for k, v in
         aug.draw(torch.Generator().manual_seed(3), (rows,), length, "cpu").items()}
    probs = {"lowpass": 0.5, "pitchshift": 0.5, "shift": 0.5, "timeinversion": 0.25, "gain": 0.5,
             "noise": 0.5, "highpass": 0.3, "bandstop": 0.5, "spliceout": 0.5, "timestretch": 0.4,
             "timemasking": 0.5}
    assert set(d) == set(probs)
    for name, p in probs.items():
        assert scipy.stats.binomtest(int(d[name]["applied"].sum()), rows, p).pvalue > 1e-4, name
    c, bw = 1191.0, 1669.0
    bounds = {("lowpass", "cut"): (c, c + bw / 2), ("highpass", "cut"): (c - bw / 2, c),
              ("bandstop", "center"): (c - bw / 2, c), ("bandstop", "bw_frac"): (0.5, 1.0),
              ("gain", "db"): (-6, 6), ("shift", "frac"): (-0.5, 0.5), ("noise", "snr"): (10.0, 25 * (1 - 0.144)),
              ("noise", "decay"): (-2, 2), ("timestretch", "ratio"): (0.9, 1.1)}
    for (name, leaf), (lo, hi) in bounds.items():
        v = d[name][leaf].ravel().astype(np.float64)
        assert lo <= v.min() and v.max() < hi + 1e-4 * abs(hi), (name, leaf)
        hist = np.histogram(v, bins=10, range=(lo, hi))[0]
        assert scipy.stats.chisquare(hist).pvalue > 1e-4, (name, leaf, hist)
    semis = 12 * np.log2(d["pitchshift"]["rate"].astype(np.float64))
    assert -4 - 1e-4 <= semis.min() and semis.max() < 4 + 1e-4
    assert scipy.stats.chisquare(np.histogram(semis, bins=10, range=(-4, 4))[0]).pvalue > 1e-4
    so = d["spliceout"]
    assert so["starts"].shape == (rows, 8) and 0 <= so["starts"].min() and so["starts"].max() < length - 400
    assert so["widths"].min() == 1 and so["widths"].max() == 400
    tm = d["timemasking"]["starts"]
    assert tm.shape == (rows, 5) and 0 <= tm.min() and tm.max() < length - int(length * 0.01)
    w = d["noise"]["w"]
    assert w.shape == (rows, length // 2 + 1, 2) and abs(w.mean()) < 1e-2 and abs(w.std() - 1) < 1e-2
