"""PyTorch port: the losses, K2's closed-form backward, dropout and the
learning-rate schedule against the JAX package, on the CPU.

Tolerances: FSL 1e-6 and CPL 1e-6 (the same float32 formulas; CPL exactly
comparable only where its sampling takes every member, M >= class size);
APL 1e-5 (arctan, tan and exp of the same float32 values, summed over up to
30^3 triplets); K2's backward 1e-5 (three small matmuls per episode in
another summation order than XLA's VJP).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from audio_few_shot_learning_tpu.losses import angular_loss as j_angular
from audio_few_shot_learning_tpu.losses import cpl_loss as j_cpl
from audio_few_shot_learning_tpu.losses import fsl_loss as j_fsl
from audio_few_shot_learning_tpu.ops import protohead as jph
from audio_few_shot_learning_tpu_torch.losses import angular_loss, cpl_loss, draw_cpl_gumbel, fsl_loss
from audio_few_shot_learning_tpu_torch.models.dropout import Dropout, dropout
from audio_few_shot_learning_tpu_torch.ops import protohead as tph
from audio_few_shot_learning_tpu_torch.train.state import scheduled_lr


def _episodes(seed, e=3, n=5, per_class=5, d=64, balanced=True):
    rng = np.random.default_rng(seed)
    protos = rng.standard_normal((e, n, d)).astype(np.float32)
    if balanced:
        labels = np.tile(np.repeat(np.arange(n), per_class), (e, 1))
    else:  # uneven classes: sizes 1 .. 2*per_class - 1 per episode
        labels = np.stack([rng.permutation(np.repeat(np.arange(n), per_class))[: n * per_class]
                           for _ in range(e)])
        labels[:, 0] = 0
    b = labels.shape[1]
    queries = rng.standard_normal((e, b, d)).astype(np.float32)
    return protos, queries, labels.astype(np.int64)


@pytest.mark.parametrize("q,n", [(25, 5), (8, 3), (1, 4)])
def test_fsl_matches_jax(q, n):
    rng = np.random.default_rng(q)
    scores = (-3 * rng.random((4, q, n))).astype(np.float32)
    labels = rng.integers(0, n, (4, q))
    want = np.asarray(jax.vmap(j_fsl)(jnp.asarray(scores), jnp.asarray(labels)))
    got = fsl_loss(torch.from_numpy(scores), torch.from_numpy(labels)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("m_extra", [0, 1, 3])
@pytest.mark.parametrize("t_param", [1.0, 6.0488])
def test_cpl_matches_jax_when_sampling_every_member(m_extra, t_param):
    """M >= class size: the Gumbel-top-M takes every member of each class, so
    the port and the JAX package agree whatever their noise; with M above
    the class size the surplus slots stay masked out."""
    protos, queries, labels = _episodes(seed=1)
    m = 5 + m_extra
    keys = jax.random.split(jax.random.PRNGKey(0), 3)
    want = np.asarray(jax.vmap(lambda p, q, lb, k: j_cpl(p, q, lb, k, m, t_param))(
        jnp.asarray(protos), jnp.asarray(queries), jnp.asarray(labels), keys))
    got = cpl_loss(torch.from_numpy(protos), torch.from_numpy(queries), torch.from_numpy(labels),
                   m, t_param, gen=torch.Generator().manual_seed(0)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_cpl_masks_slots_of_small_classes():
    """Uneven classes, M = the largest class: classes smaller than M leave
    masked slots, and the loss still equals the JAX package's."""
    protos, queries, labels = _episodes(seed=2, e=4, n=4, per_class=3, balanced=False)
    m = max(int(np.bincount(row).max()) for row in labels)
    assert min(int(np.bincount(row, minlength=4).min()) for row in labels) < m
    keys = jax.random.split(jax.random.PRNGKey(1), 4)
    want = np.asarray(jax.vmap(lambda p, q, lb, k: j_cpl(p, q, lb, k, m, 2.0))(
        jnp.asarray(protos), jnp.asarray(queries), jnp.asarray(labels), keys))
    got = cpl_loss(torch.from_numpy(protos), torch.from_numpy(queries), torch.from_numpy(labels),
                   m, 2.0, gen=torch.Generator().manual_seed(1)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_cpl_subsampling_draws_from_the_generator():
    """M < class size: the draws come from the generator (same seed, same
    loss; given noise, the same loss as drawing it), the loss is finite and
    of the full loss's scale, and its gradient is finite."""
    protos, queries, labels = _episodes(seed=3)
    args = (torch.from_numpy(protos), torch.from_numpy(queries).requires_grad_(True),
            torch.from_numpy(labels), 3, 6.0)
    a = cpl_loss(*args, gen=torch.Generator().manual_seed(7))
    b = cpl_loss(*args, gen=torch.Generator().manual_seed(7))
    noise = draw_cpl_gumbel(torch.Generator().manual_seed(7), 3, 25, 5, "cpu")
    torch.testing.assert_close(a, b, atol=0, rtol=0)
    torch.testing.assert_close(cpl_loss(*args, gumbel=noise), a, atol=0, rtol=0)
    full = cpl_loss(*args[:3], 5, 6.0, gen=torch.Generator())
    assert torch.isfinite(a).all() and ((0.25 * full < a) & (a < 4 * full)).all()
    a.sum().backward()
    assert torch.isfinite(args[1].grad).all()


@pytest.mark.parametrize("anchors", [True, False])
@pytest.mark.parametrize("angle", [0.0, 30.0, 45.0])
def test_angular_matches_jax(anchors, angle):
    protos, queries, labels = _episodes(seed=4, e=2, d=32)
    want = np.asarray(jax.vmap(lambda p, q, lb: j_angular(p, q, lb, angle, anchors))(
        jnp.asarray(protos), jnp.asarray(queries), jnp.asarray(labels)))
    got = angular_loss(torch.from_numpy(protos), torch.from_numpy(queries),
                       torch.from_numpy(labels), angle, anchors).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("e,s,q,d,n,empty_class,strided", [
    (3, 12, 7, 32, 4, True, False),  # an empty class: zero prototype, no support gradient
    (2, 25, 25, 256, 5, False, True),  # the flagship head, slices of one [E, S+Q, D] tensor
    (1, 25, 25, 64, 5, False, False),  # a wav episode
])
def test_k2_backward_matches_jax_vjp(e, s, q, d, n, empty_class, strided):
    """The closed-form VJP (the backward of K2 on the card) against jax.vjp
    of the JAX package's plain head, 1e-5, on episode-strided inputs as the
    train path gives them."""
    rng = np.random.default_rng(e * s + d)
    fused = rng.standard_normal((e, s + q, d)).astype(np.float32)
    labels = rng.integers(0, n - 1 if empty_class else n, (e, s)).astype(np.int64)
    if not empty_class:
        labels[:, :n] = np.arange(n)
    cot = rng.standard_normal((e, q, n)).astype(np.float32)
    sup_np, qry_np = fused[:, :s], fused[:, s:]
    scores, vjp = jax.vjp(
        lambda a, b: jph._batched_episode_scores_xla(a, jnp.asarray(labels), b, n),
        jnp.asarray(sup_np), jnp.asarray(qry_np),
    )
    want_s, want_q = vjp(jnp.asarray(cot))

    t = torch.from_numpy(fused)
    sup, qry = (t[:, :s], t[:, s:]) if strided else (t[:, :s].contiguous(), t[:, s:].contiguous())
    got_s, got_q = tph.episode_scores_backward(
        torch.from_numpy(cot), sup, torch.from_numpy(labels), qry,
        torch.from_numpy(np.array(scores)), n,
    )
    assert got_s.shape == sup.shape and got_q.shape == qry.shape
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got_q.numpy(), np.asarray(want_q), atol=1e-5, rtol=0)
    if empty_class:  # no support row belongs to the empty class n-1
        assert np.isfinite(got_s.numpy()).all()


def test_k2_backward_is_zero_where_the_distance_was_clamped():
    """A query on a prototype: d2 clamps to 0, the distance is the floor and
    that score passes no gradient."""
    sup = torch.tensor([[[1.0, 2.0], [3.0, -1.0]]])
    labels = torch.tensor([[0, 1]])
    qry = torch.tensor([[[1.0, 2.0]]])
    scores = tph.batched_episode_scores_reference(sup, labels, qry, 2)
    assert float(-scores[0, 0, 0]) == tph.DIST_FLOOR
    g_s, g_q = tph.episode_scores_backward(torch.ones_like(scores), sup, labels, qry, scores, 2)
    # only the distance to class 1 contributes: d/dq |q - p1| = (q - p1) / |q - p1|
    diff = qry[0, 0] - sup[0, 1]
    torch.testing.assert_close(g_q[0, 0], -diff / diff.norm())
    torch.testing.assert_close(g_s[0, 0], torch.zeros(2))


def test_dropout_keep_rate_and_scale():
    """Keep rate 1 - p within 5 standard deviations over 200 000 draws, the
    kept elements scaled by 1 / (1 - p), the mask a function of the
    generator's state; identity for p = 0 and in eval mode."""
    p, n = 0.3, 200_000
    x = torch.ones(n)
    y = dropout(x, p, torch.Generator().manual_seed(0))
    kept = y != 0
    rate = kept.float().mean().item()
    assert abs(rate - (1 - p)) < 5 * np.sqrt(p * (1 - p) / n)
    torch.testing.assert_close(y[kept], torch.full((int(kept.sum()),), 1 / (1 - p)))
    torch.testing.assert_close(dropout(x, p, torch.Generator().manual_seed(0)), y, atol=0, rtol=0)
    assert dropout(x, 0.0, None) is x
    layer = Dropout(p)
    assert layer.eval()(x) is x
    with pytest.raises(ValueError, match="generator"):
        layer.train()(x)


@pytest.mark.parametrize("milestones,gamma", [((1, 2), 0.5), ((20, 40, 60), 0.376), ((0, 2, 2), 0.1)])
def test_schedule_matches_optax(milestones, gamma):
    """The learning rate of every update over 3 epochs of 4 steps equals
    optax's piecewise-constant schedule at boundaries m * steps_per_epoch,
    which the JAX package's Adam reads at the update count."""
    lr, spe = 1e-3, 4
    sched = optax.piecewise_constant_schedule(lr, {m * spe: gamma for m in milestones})
    want = np.array([float(sched(k)) for k in range(3 * spe)])
    got = np.array([scheduled_lr(k, lr, milestones, gamma, spe) for k in range(3 * spe)])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
