"""PyTorch port: SpecAugment views (plain version of K1) against the JAX
package's ``_views_xla`` and, in interpret mode, its Pallas kernel
``_views_pallas``; Hermite warp positions from the same control draws; mask
draws by distribution. The CUDA kernel itself is held against the plain
version on the card (``test_torch_port_cuda.py``, ``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import scipy.stats
import torch

from _torch_port_helpers import jax_views, numpy_draws, torch_draws
from audio_few_shot_learning_tpu.ops import specaugment as jsa
from audio_few_shot_learning_tpu_torch.config import SpecAugParams
from audio_few_shot_learning_tpu_torch.ops import specaugment as tsa

E, B, F, T, W = 2, 3, 16, 40, 6


def _spec(dtype=np.float32, seed=0):
    return np.random.default_rng(seed).standard_normal((E, B, F, T)).astype(dtype)


@pytest.mark.parametrize("t_len,w", [(157, 22), (40, 6)])
def test_hermite_positions_match_jax(t_len, w):
    """Same (warp_p, warp_d) draws -> same source curve (atol 1e-6)."""
    keys = jax.random.split(jax.random.PRNGKey(3), 64)

    def draws(k):  # the JAX function's own draws, replayed
        kp, kd = jax.random.split(k)
        return jax.random.randint(kp, (), w, t_len - w), jax.random.randint(kd, (), -w, w)

    warp_p, warp_d = jax.vmap(draws)(keys)
    want = np.asarray(jax.vmap(lambda k: jsa._hermite_warp_positions(k, t_len, w))(keys))
    got = tsa.hermite_warp_positions(
        torch.from_numpy(np.array(warp_p)), torch.from_numpy(np.array(warp_d)), t_len
    ).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_views_reference_matches_views_xla():
    spec = _spec()
    draws = numpy_draws(np.random.default_rng(1), E, B, F, T, W)
    want = jax_views(spec, draws, mask_value=-1.5)
    got = tsa.views_reference(torch.from_numpy(spec), *torch_draws(draws), -1.5).numpy()
    assert got.shape == (E, B, 4, F, T)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got[:, :, 0], spec)


def test_views_reference_bf16_matches_views_xla():
    """bf16 specs: the warp is computed in f32 and rounded once to bf16, so
    the two agree within one bf16 rounding step (2^-8 relative)."""
    spec32 = _spec()
    draws = numpy_draws(np.random.default_rng(2), E, B, F, T, W)
    want = jax_views(spec32.astype(ml_dtypes.bfloat16), draws).astype(np.float32)
    got = tsa.views_reference(
        torch.from_numpy(spec32).to(torch.bfloat16), *torch_draws(draws), 0.0
    ).float().numpy()
    np.testing.assert_allclose(got, want, atol=2.0**-8 * np.abs(spec32).max(), rtol=0)
    np.testing.assert_array_equal(got[:, :, [0, 2, 3]], want[:, :, [0, 2, 3]])


def test_views_reference_matches_pallas_interpret():
    """The TPU kernel (dense [T,T] warp matrix) in interpret mode, atol 1e-5."""
    from jax.experimental.pallas import tpu as pltpu

    spec = _spec(seed=3)
    ys, tm, fm = numpy_draws(np.random.default_rng(4), E, B, F, T, W)
    got = tsa.views_reference(torch.from_numpy(spec), *torch_draws((ys, tm, fm)), 0.0).numpy()
    for e in range(E):
        mats = jax.vmap(lambda y: jsa._warp_matrix(y, T))(jnp.asarray(ys[e]))
        with pltpu.force_tpu_interpret_mode():
            want = jsa._views_pallas(
                jnp.asarray(spec[e]), mats, jnp.asarray(tm[e]), jnp.asarray(fm[e]), 0.0
            )
        np.testing.assert_allclose(got[e], np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("which", ["time", "freq"])
def test_mask_widths_uniform_and_in_range(which):
    """Mask draws by distribution: widths uniform over [1, max_len], starts
    in [0, L - w), over the same support as the JAX draws."""
    n, length, mask_param, p = 4000, (157 if which == "time" else 128), 16, 0.282
    gen = torch.Generator().manual_seed(7)
    keys = jax.random.split(jax.random.PRNGKey(7), 2000)
    if which == "time":
        lo, hi = tsa.mask_bounds_time(gen, (n,), 1, mask_param, p, length, "cpu")
        jlo, jhi = jax.vmap(lambda k: jsa._mask_bounds_time(k, 1, mask_param, p, length))(keys)
        max_len = min(mask_param, int(p * length))
    else:
        lo, hi = tsa.mask_bounds_freq(gen, (n,), 1, mask_param, length, "cpu")
        jlo, jhi = jax.vmap(lambda k: jsa._mask_bounds_freq(k, 1, mask_param, length))(keys)
        max_len = mask_param
    width, start = (hi - lo).numpy().ravel(), lo.numpy().ravel()
    assert width.min() >= 1 and width.max() <= max_len
    assert start.min() >= 0 and (start + width).max() <= length - 1
    counts = np.bincount(width, minlength=max_len + 1)[1:]
    assert scipy.stats.chisquare(counts).pvalue > 1e-4, counts
    jwidth = np.asarray(jhi - jlo).ravel()
    assert set(np.unique(jwidth)) == set(np.unique(width)) == set(range(1, max_len + 1))


def test_interval_mask_matches_jax():
    lo = np.array([[3, 10], [0, 30]])
    hi = np.array([[7, 12], [2, 40]])
    want = np.stack([np.asarray(jsa._interval_mask(jnp.asarray(a), jnp.asarray(b), 40))
                     for a, b in zip(lo, hi)])
    got = tsa.interval_mask(torch.from_numpy(lo), torch.from_numpy(hi), 40).numpy()
    np.testing.assert_array_equal(got, want)


def test_spec_augment_views_layouts_and_draws():
    params = SpecAugParams(use=True, mask_param=8, W=W, num_mask=2, mask_value=0.5, p=0.282)
    spec = torch.from_numpy(_spec(seed=5))
    views = tsa.spec_augment_views(spec, torch.Generator().manual_seed(1), params)
    again = tsa.spec_augment_views(spec, torch.Generator().manual_seed(1), params)
    assert views.shape == (E, B, 4, F, T)
    torch.testing.assert_close(views, again)
    torch.testing.assert_close(views[:, :, 0], spec)
    draws = tsa.draw_views_params(torch.Generator().manual_seed(2), params, E, B, F, T, "cpu")
    torch.testing.assert_close(
        tsa.spec_augment_views(spec, None, params, draws=draws),
        tsa.views_reference(spec, *draws, 0.5),
    )
    # an unbatched [B, F, T] call is the E=1 case
    one = tsa.spec_augment_views(spec[0], None, params, draws=tuple(d[0] for d in draws))
    assert one.shape == (B, 4, F, T)
    torch.testing.assert_close(one, tsa.views_reference(spec, *draws, 0.5)[0])


def test_views_cuda_refuses_cpu_tensors():
    """The kernel wrapper never computes a CPU tensor: it raises."""
    spec = torch.zeros((1, 2, F, T))
    draws = tsa.draw_views_params(
        torch.Generator().manual_seed(0), SpecAugParams(use=True, W=W), 1, 2, F, T, "cpu"
    )
    with pytest.raises(ValueError, match="CUDA"):
        tsa.views_cuda(spec, *draws, 0.0)
    with pytest.raises(ValueError, match="E, B, F, T"):
        tsa.views_cuda(spec[0], *draws, 0.0)
