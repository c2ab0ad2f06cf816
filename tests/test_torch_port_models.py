"""PyTorch port: encoder, attention, projection and episode model against the
JAX modules on bridged weights and the same numpy inputs (float32, CPU).

Tolerances: 1e-4 on features (same float32 math, other summation orders in
the convolutions), 1e-3 on scores (distances of norm-~10 features).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import configs, jax_variables, port_model

FEAT_ATOL = 1e-4
SCORE_ATOL = 1e-3
_CACHE = {}


def _setup(geometry, use_attention=True, fold_bn_eval=True):
    key = (geometry, use_attention, fold_bn_eval)
    if key not in _CACHE:
        jexp, jmdl, texp, tmdl, feat_shape = configs(geometry, use_attention, fold_bn_eval)
        jmodel, variables = jax_variables(jexp, jmdl, feat_shape)
        tmodel = port_model(texp, tmdl, feat_shape, variables)
        _CACHE[key] = (jmodel.bind(variables), tmodel, feat_shape)
    return _CACHE[key]


@pytest.mark.parametrize("geometry", ["small", "fprime", "gru_bi"])
@pytest.mark.parametrize("fold", [True, False])
def test_hybrid_matches_jax(geometry, fold):
    jbound, tmodel, (f, t) = _setup(geometry, fold_bn_eval=fold)
    x = np.random.default_rng(1).standard_normal((6, f, t)).astype(np.float32)
    want = np.asarray(jbound.backbone(jnp.asarray(x), train=False))
    with torch.no_grad():
        got = tmodel.backbone(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=FEAT_ATOL, rtol=0)


@pytest.mark.parametrize("geometry", ["small", "fprime"])
def test_bn_fold_matches_unfolded(geometry):
    """The eval BN fold changes nothing but rounding."""
    _, folded, (f, t) = _setup(geometry, fold_bn_eval=True)
    _, unfolded, _ = _setup(geometry, fold_bn_eval=False)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((4, f, t)).astype(np.float32))
    with torch.no_grad():
        np.testing.assert_allclose(
            folded.backbone(x).numpy(), unfolded.backbone(x).numpy(), atol=FEAT_ATOL, rtol=0
        )


@pytest.mark.parametrize("geometry", ["small", "fprime"])
def test_attention_and_projection_match_jax(geometry):
    jbound, tmodel, _ = _setup(geometry)
    d = tmodel.attention_model.encoder_layer.linear1.in_features
    tokens = np.random.default_rng(3).standard_normal((7, 4, d)).astype(np.float32)
    want = np.asarray(jbound.attention(jnp.asarray(tokens), train=False))
    proj_want = np.asarray(jbound.projection(jnp.asarray(want)))
    with torch.no_grad():
        got = tmodel.attention_model(torch.from_numpy(tokens))
        proj_got = tmodel.projection_head(got).numpy()
    np.testing.assert_allclose(got.numpy(), want, atol=FEAT_ATOL, rtol=0)
    np.testing.assert_allclose(proj_got, proj_want, atol=FEAT_ATOL, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(proj_got, axis=-1), 1.0, atol=1e-5)


@pytest.mark.parametrize(
    "geometry,use_attention", [("small", True), ("fprime", True), ("small", False)]
)
def test_episode_model_scores_match_jax(geometry, use_attention):
    jbound, tmodel, (f, t) = _setup(geometry, use_attention=use_attention)
    rng = np.random.default_rng(4)
    e, n_way, shots, queries, v = 2, 3, 2, 2, 4
    sup = rng.standard_normal((e, n_way * shots, v, f, t)).astype(np.float32)
    qry = rng.standard_normal((e, n_way * queries, v, f, t)).astype(np.float32)
    labels = np.tile(np.repeat(np.arange(n_way), shots), (e, 1))
    want = jax.jit(lambda s_, q_, l_: jbound(s_, q_, l_, n_way, train=False))(sup, qry, labels)
    with torch.no_grad():
        got = tmodel(torch.from_numpy(sup), torch.from_numpy(qry), torch.from_numpy(labels), n_way)
    np.testing.assert_allclose(
        got.support_features.numpy(), np.asarray(want.support_features), atol=FEAT_ATOL, rtol=0
    )
    np.testing.assert_allclose(
        got.query_features.numpy(), np.asarray(want.query_features), atol=FEAT_ATOL, rtol=0
    )
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), atol=SCORE_ATOL, rtol=0)
    assert (got.scores.argmax(-1).numpy() == np.asarray(want.scores).argmax(-1)).all()


def test_single_episode_is_the_e1_case():
    _, tmodel, (f, t) = _setup("small")
    rng = np.random.default_rng(5)
    sup = torch.from_numpy(rng.standard_normal((4, 4, f, t)).astype(np.float32))
    qry = torch.from_numpy(rng.standard_normal((2, 4, f, t)).astype(np.float32))
    labels = torch.tensor([0, 0, 1, 1])
    with torch.no_grad():
        one = tmodel(sup, qry, labels, 2)
        batched = tmodel(sup[None], qry[None], labels[None], 2)
    assert one.scores.shape == (2, 2)
    torch.testing.assert_close(one.scores, batched.scores[0])


def test_equal_view_count_guard():
    _, tmodel, (f, t) = _setup("small")
    sup = torch.zeros((4, 4, f, t))
    qry = torch.zeros((2, 1, f, t))
    with pytest.raises(ValueError, match="equal support/query view counts"):
        tmodel(sup, qry, torch.tensor([0, 0, 1, 1]), 2)


def test_pool_collapse_raises():
    from audio_few_shot_learning_tpu_torch.models.encoders import conv_output_shape

    with pytest.raises(ValueError, match="collapses"):
        conv_output_shape((40, 157), (3, 3))
    assert conv_output_shape((128, 157), (3, 3)) == (1, 1)
    assert conv_output_shape((48, 64), (2, 2)) == (3, 4)
