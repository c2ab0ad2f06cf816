"""PyTorch port: log-mel extraction (``ops/mel.py``) against the JAX package.

The filterbanks and window are copies, so they agree exactly. The power
spectrogram goes through another FFT (``torch.fft`` vs ``jnp.fft``), so it
agrees to float32 rounding. The projection + log (K3's plain version) is
held against ``_mel_log_xla`` and against the Pallas kernel in interpret
mode at 1e-3 dB, and the whole ``MelSpec`` of both flavours at the JAX
suite's own tolerances (tests/test_mel.py: 5e-3 dB on noise, 6e-2 dB on a
two-tone sine). The band table that K3 reads is checked here too; the
kernel itself is held against ``mel_log_reference`` on the card
(tests/test_torch_port_cuda.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io.wavfile
import torch

from audio_few_shot_learning_tpu.ops import mel as jmel
from audio_few_shot_learning_tpu.preprocessing.audio_io import load_audio as jax_load_audio
from audio_few_shot_learning_tpu_torch.ops import mel
from audio_few_shot_learning_tpu_torch.preprocessing.audio_io import load_audio

DB_TOL = 1e-3  # K3 vs its references: same f32 sum in another order
SR = 16000
FLAVORS = {"online": ("htk", None), "offline": ("slaney", "slaney")}


def _noise(length, seed):
    return (np.random.default_rng(seed).standard_normal(length) * 0.3).astype(np.float32)


def _two_tone(length=80000):
    t = np.arange(length) / SR
    return (0.5 * np.sin(2 * np.pi * 440.0 * t) + 0.2 * np.sin(2 * np.pi * 3000.0 * t)).astype(np.float32)


@pytest.mark.parametrize("flavor", sorted(FLAVORS))
def test_filterbank_and_window_exact(flavor):
    scale, norm = FLAVORS[flavor]
    np.testing.assert_array_equal(
        mel.mel_filterbank(scale=scale, norm=norm), jmel.mel_filterbank(scale=scale, norm=norm)
    )
    np.testing.assert_array_equal(mel.MelSpec(flavor).fb, jmel.MelSpec(flavor=flavor).fb)
    np.testing.assert_array_equal(mel._hann(1024), jmel._hann(1024))


@pytest.mark.parametrize("pad_mode", ["reflect", "constant"])
@pytest.mark.parametrize("length", [16000, 12345])
def test_power_spectrogram_matches_jax(pad_mode, length):
    wav = _noise(length, 0)
    got = mel.power_spectrogram(torch.from_numpy(wav), pad_mode=pad_mode)
    want = np.asarray(jmel.power_spectrogram(jnp.asarray(wav), pad_mode=pad_mode))
    assert got.shape == want.shape == (1 + length // 512, 513) and got.is_contiguous()
    # two FFT libraries in float32: relative to each frame's largest bin
    err = np.abs(got.numpy() - want) / want.max(axis=-1, keepdims=True)
    assert err.max() < 1e-5, err.max()


@pytest.mark.parametrize("length", [1, 2, 300, 512, 700])
def test_short_clip_reflect_pad_matches_jnp_pad(length):
    """``F.pad(mode="reflect")`` refuses a pad of 512 on a clip of 512
    samples or fewer; the port reflects again and again as ``jnp.pad`` does."""
    wav = _noise(length, 1)
    got = mel._center_pad(torch.from_numpy(wav), 512, "reflect").numpy()
    np.testing.assert_array_equal(got, np.asarray(jnp.pad(jnp.asarray(wav), 512, mode="reflect")))
    spec = mel.MelSpec("online")(torch.from_numpy(wav)).numpy()
    want = np.asarray(jmel.MelSpec(flavor="online", use_pallas=False)(jnp.asarray(wav)))
    np.testing.assert_allclose(spec, want, atol=5e-3, rtol=0)


def test_empty_clip_reflect_raises():
    with pytest.raises(ValueError, match="empty"):
        mel.power_spectrogram(torch.zeros(0))


def _pspec_rows(flavor, n_clips=3, length=16000, seed=2):
    pad = "reflect" if flavor == "online" else "constant"
    wav = np.stack([_noise(length, seed + i) for i in range(n_clips)])
    return np.array(jmel.power_spectrogram(jnp.asarray(wav), pad_mode=pad)).reshape(-1, 513)


@pytest.mark.parametrize("flavor", sorted(FLAVORS))
def test_mel_log_reference_matches_xla(flavor):
    spec = mel.MelSpec(flavor)
    rows = _pspec_rows(flavor)
    got = mel.mel_log_reference(torch.from_numpy(rows), torch.from_numpy(spec.fb), spec.log_mult, spec.eps)
    want = np.asarray(jmel._mel_log_xla(jnp.asarray(rows), jnp.asarray(spec.fb), spec.log_mult, spec.eps))
    np.testing.assert_allclose(got.numpy(), want, atol=DB_TOL, rtol=0)


@pytest.mark.parametrize("flavor", sorted(FLAVORS))
def test_mel_log_reference_matches_pallas_interpret(flavor):
    from jax.experimental.pallas import tpu as pltpu

    spec = mel.MelSpec(flavor)
    rows = _pspec_rows(flavor, n_clips=2, length=8000, seed=5)  # M = 32: a ragged 256-row tile
    got = mel.mel_log_reference(torch.from_numpy(rows), torch.from_numpy(spec.fb), spec.log_mult, spec.eps)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(
            jmel._mel_log_pallas(jnp.asarray(rows), jnp.asarray(spec.fb), spec.log_mult, spec.eps)
        )
    np.testing.assert_allclose(got.numpy(), want, atol=DB_TOL, rtol=0)


def test_offline_eps_is_added_in_float32():
    """2**-52 added to a float32 sum stays float32: an all-zero power row
    gives 10*log10(2**-52) with no promotion to float64."""
    spec = mel.MelSpec("offline")
    out = mel.mel_log_reference(torch.zeros((2, 513)), torch.from_numpy(spec.fb), spec.log_mult, spec.eps)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), 10 * np.log10(np.float32(2.0**-52)), rtol=1e-6)


@pytest.mark.parametrize("flavor", sorted(FLAVORS))
@pytest.mark.parametrize("length", [16000, 80000])
def test_melspec_noise_matches_jax(flavor, length):
    wav = np.stack([_noise(length, 7), _noise(length, 8)])
    got = mel.MelSpec(flavor)(torch.from_numpy(wav)).numpy()
    want = np.asarray(jmel.MelSpec(flavor=flavor, use_pallas=False)(jnp.asarray(wav)))
    assert got.shape == want.shape == (2, 128, 1 + length // 512)
    np.testing.assert_allclose(got, want, atol=5e-3, rtol=0)


@pytest.mark.parametrize("flavor", sorted(FLAVORS))
def test_melspec_two_tone_matches_jax(flavor):
    wav = _two_tone()
    got = mel.MelSpec(flavor)(torch.from_numpy(wav)).numpy()
    want = np.asarray(jmel.MelSpec(flavor=flavor, use_pallas=False)(jnp.asarray(wav)))
    if flavor == "offline":
        # eps = 2**-52 does not floor the f32 FFT noise floor: bins more than
        # 90 dB below the peak are FFT rounding noise (tests/test_mel.py:337)
        audible = want > want.max() - 90.0
        assert audible.mean() > 0.15
        got, want = got[audible], want[audible]
    np.testing.assert_allclose(got, want, atol=6e-2, rtol=0)


@pytest.mark.parametrize("flavor", sorted(FLAVORS))
def test_band_table_packs_filterbank_exactly(flavor):
    fb = mel.MelSpec(flavor).fb
    table = mel.band_table(fb)
    lo, length, offset = (t.numpy() for t in (table.lo, table.length, table.offset))
    assert (table.n_bins, table.n_mels) == fb.shape
    assert 1 <= length.min() and length.max() <= 24  # narrow triangles, as K3's design counts
    assert table.weights.numel() == (fb != 0).sum() == length.sum()
    dense = np.zeros_like(fb)
    for n in range(fb.shape[1]):
        dense[lo[n] : lo[n] + length[n], n] = table.weights.numpy()[offset[n] : offset[n] + length[n]]
    np.testing.assert_array_equal(dense, fb)


def test_band_table_refuses_weights_outside_ranges():
    fb = mel.MelSpec("online").fb
    lo, hi = mel.band_ranges(fb)
    with pytest.raises(ValueError, match="outside the band ranges"):
        mel.band_table(fb, lo + 1, hi)
    with pytest.raises(ValueError, match="do not fit"):
        mel.band_table(fb, lo, hi + 600)
    zero_band = fb.copy()
    zero_band[:, 5] = 0
    table = mel.band_table(zero_band)
    assert table.length[5] == 0


def test_mel_log_cpu_returns_transposed_reference_and_cuda_wrapper_refuses_cpu():
    spec = mel.MelSpec("online")
    pspec = torch.from_numpy(_pspec_rows("online").reshape(3, 32, 513))
    fb = torch.from_numpy(spec.fb)
    got = mel.mel_log(pspec, fb, spec.log_mult, spec.eps)
    assert got.shape == (3, 128, 32)
    torch.testing.assert_close(got, mel.mel_log_reference(pspec, fb, spec.log_mult, spec.eps).transpose(-1, -2))
    with pytest.raises(ValueError, match="CUDA"):
        mel.mel_log_cuda(pspec, fb, spec.log_mult, spec.eps)


@pytest.mark.parametrize("encoding,sr_in", [("int16", 16000), ("float32", 22050), ("int16", 8000)])
def test_load_audio_matches_jax(tmp_path, encoding, sr_in):
    rng = np.random.default_rng(9)
    x = rng.uniform(-0.5, 0.5, (sr_in // 2, 2)).astype(np.float32)
    data = (x * 32767).astype(np.int16) if encoding == "int16" else x
    path = tmp_path / "clip.wav"
    scipy.io.wavfile.write(path, sr_in, data)
    got = load_audio(path, sr=SR)
    assert got.dtype == np.float32 and got.shape == (SR // 2,)
    np.testing.assert_array_equal(got, jax_load_audio(path, sr=SR))
