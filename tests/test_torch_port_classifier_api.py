"""PyTorch port: the reference's classifier object protocol and the few-shot
utility functions, against the JAX package's ``models/classifier_api.py``
and ``ops/util_functions.py`` on the same weights and views, in float32.

Tolerances: support and query features and prototypes 1e-4, scores 1e-3
(the port's slice tests' bars), the utility functions 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import configs, jax_variables
from audio_few_shot_learning_tpu.models import classifier_api as japi
from audio_few_shot_learning_tpu.ops import util_functions as jutil
from audio_few_shot_learning_tpu_torch.models import classifier_api as tapi
from audio_few_shot_learning_tpu_torch.ops import util_functions as tutil
from audio_few_shot_learning_tpu_torch.train.weights import from_jax_variables

FEAT_ATOL, SCORE_ATOL, UTIL_ATOL = 1e-4, 1e-3, 1e-6
N_WAY, K_SHOT, N_QUERY, V = 3, 2, 4, 4
CLASSES = ["FewShotClassifier", "PrototypicalNetworks", "ContrastivePrototypicalNetworks",
           "ContrastivePrototypicalNetworksWithoutAttention"]


@pytest.fixture(scope="module")
def bundles():
    """attention -> (attention, JAX configs, port configs, variables, views);
    made once per module for each model the tests ask for."""
    made = {}

    def get(attention):
        if attention not in made:
            jexp, jmdl, texp, tmdl, (f, t) = configs("small", use_attention=attention)
            _, variables = jax_variables(jexp, jmdl, (f, t), seed=13)
            rng = np.random.default_rng(7)
            sup = rng.standard_normal((N_WAY * K_SHOT, V, f, t)).astype(np.float32)
            qry = rng.standard_normal((N_QUERY, V, f, t)).astype(np.float32)
            labels = np.repeat(np.arange(N_WAY), K_SHOT)
            made[attention] = (attention, jexp, jmdl, texp, tmdl, variables, sup, qry, labels)
        return made[attention]

    return get


def _pair(setup, cls, **hooks):
    _, jexp, jmdl, texp, tmdl, variables, sup, qry, labels = setup
    j = getattr(japi, cls)(jexp, jmdl, variables=variables,
                           **{k: (None if v is None else jnp.asarray(v)) if k == "feature_centering" else v
                              for k, v in hooks.items()})
    p = getattr(tapi, cls)(texp, tmdl, state_dict=from_jax_variables(variables), **hooks)
    j.process_support_set(jnp.asarray(sup), jnp.asarray(labels))
    p.process_support_set(sup, labels)
    return j, p


def _close(got, want, atol):
    np.testing.assert_allclose(got.detach().cpu().numpy(), np.asarray(want), atol=atol, rtol=0)


# each class on the model it is made for; the base class on both
@pytest.mark.parametrize("cls,attention", [(c, c != CLASSES[3]) for c in CLASSES] + [(CLASSES[0], False)])
def test_classifier_matches_jax(bundles, cls, attention):
    setup = bundles(attention)
    qry = setup[7]
    j, p = _pair(setup, cls)
    assert p.model.training is False and p.device == torch.device("cpu")
    _close(p.support_features, j.support_features, FEAT_ATOL)
    np.testing.assert_array_equal(p.support_labels.numpy(), np.asarray(j.support_labels))  # tiled xV without attention
    _close(p.prototypes, j.prototypes, FEAT_ATOL)
    _close(p.compute_query_features(qry), j.compute_query_features(jnp.asarray(qry)), FEAT_ATOL)
    scores = p(qry, inference=True)
    want = j(jnp.asarray(qry), inference=True)
    _close(scores, want, SCORE_ATOL)
    np.testing.assert_array_equal(scores.argmax(-1).numpy(), np.asarray(want).argmax(-1))
    # a call without inference: features for the base class, scores for ProtoNets
    plain = p(qry)
    _close(plain, j(jnp.asarray(qry)), SCORE_ATOL if cls != "FewShotClassifier" else FEAT_ATOL)
    feats = p.compute_query_features(qry)
    _close(p.cosine_distance_to_prototypes(feats),
           j.cosine_distance_to_prototypes(j.compute_query_features(jnp.asarray(qry))), SCORE_ATOL)
    assert p.is_transductive() is False


@pytest.mark.parametrize("cls", ["ContrastivePrototypicalNetworks", "ContrastivePrototypicalNetworksWithoutAttention"])
@pytest.mark.parametrize("project", [True, False])
def test_contrastive_forward_matches_jax(bundles, cls, project):
    setup = bundles(cls == "ContrastivePrototypicalNetworks")
    qry = setup[7]
    j, p = _pair(setup, cls)
    key = jax.random.PRNGKey(3)
    # the permutation the JAX method draws from its key, given to the port as data
    perm = np.array(jax.random.permutation(key, jnp.arange(1, V)))
    jf, jp = j.contrastive_forward(jnp.asarray(qry), project, key=key)
    pf, pp = p.contrastive_forward(qry, project, perm=perm)
    _close(pf, jf, FEAT_ATOL)
    _close(pp, jp, FEAT_ATOL)
    # no permutation: the identity on both sides; one from a generator is a permutation of 1..V-1
    _close(p.contrastive_forward(qry, project)[0], j.contrastive_forward(jnp.asarray(qry), project)[0], FEAT_ATOL)
    gen = torch.Generator().manual_seed(0)
    drawn = p.contrastive_forward(qry, project, generator=gen)[0]
    assert drawn.shape == pf.shape and torch.isfinite(drawn).all()


@pytest.mark.parametrize("hooks", [
    {"use_softmax": True},
    {"feature_centering": "mean"},
    {"feature_normalization": 2.0},
    {"use_softmax": True, "feature_centering": "mean", "feature_normalization": 2.0},
], ids=["softmax", "centering", "p2", "all"])
def test_hooks_match_jax(bundles, hooks):
    setup = bundles(True)
    if hooks.get("feature_centering") == "mean":
        hooks = {**hooks, "feature_centering": np.random.default_rng(1).standard_normal(V * 64).astype(np.float32)}
    qry = setup[7]
    j, p = _pair(setup, "PrototypicalNetworks", **hooks)
    _close(p.support_features, j.support_features, FEAT_ATOL)
    out = p(qry)
    _close(out, j(jnp.asarray(qry)), SCORE_ATOL)
    if hooks.get("use_softmax"):
        np.testing.assert_allclose(out.sum(-1).numpy(), 1.0, atol=1e-6)
        _close(p.softmax_if_specified(out, 2.0), j.softmax_if_specified(jnp.asarray(out.numpy()), 2.0), 1e-6)


def test_model_from_a_generator_is_reproducible():
    _, _, texp, tmdl, (f, t) = configs("small")
    rng = np.random.default_rng(0)
    sup = rng.standard_normal((N_WAY * K_SHOT, V, f, t)).astype(np.float32)
    labels = np.repeat(np.arange(N_WAY), K_SHOT)
    a, b = (tapi.PrototypicalNetworks(texp, tmdl, generator=torch.Generator().manual_seed(5)) for _ in range(2))
    c = tapi.PrototypicalNetworks(texp, tmdl, generator=torch.Generator().manual_seed(6))
    for m in (a, b, c):
        m.process_support_set(sup, labels)
    assert torch.equal(a.prototypes, b.prototypes)
    assert not torch.equal(a.prototypes, c.prototypes)


def test_classifier_without_a_card_raises(monkeypatch):
    _, _, texp, tmdl, _ = configs("small")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tapi.PrototypicalNetworks(texp, tmdl, device="cuda")


# ---------------------------------------------------------------------------
# util_functions
# ---------------------------------------------------------------------------


def test_util_functions_match_jax():
    rng = np.random.default_rng(11)
    logits = (3 * rng.standard_normal((9, 5))).astype(np.float32)
    feats = rng.standard_normal((12, 16)).astype(np.float32)
    protos = rng.standard_normal((4, 16)).astype(np.float32)
    t = torch.from_numpy
    np.testing.assert_allclose(tutil.entropy(t(logits)).numpy(), np.asarray(jutil.entropy(jnp.asarray(logits))),
                               atol=UTIL_ATOL, rtol=0)
    for power in (0.5, 2.0):
        np.testing.assert_allclose(tutil.power_transform(t(feats), power).numpy(),
                                   np.asarray(jutil.power_transform(jnp.asarray(feats), power)),
                                   atol=UTIL_ATOL, rtol=0)
    np.testing.assert_allclose(tutil.cosine_scores(t(feats), t(protos)).numpy(),
                               np.asarray(jutil.cosine_scores(jnp.asarray(feats), jnp.asarray(protos))),
                               atol=UTIL_ATOL, rtol=0)
    # distinct pairwise distances, so the neighbour order is defined
    d = np.linalg.norm(feats[:, None] - feats[None], axis=-1)
    assert all(len(np.unique(row)) == len(row) for row in d)
    for k in (1, 3, 5):
        got = tutil.k_nearest_neighbours(t(feats), k).numpy()
        want = np.asarray(jutil.k_nearest_neighbours(jnp.asarray(feats), k))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, np.argsort(d, axis=1)[:, 1 : k + 1])
