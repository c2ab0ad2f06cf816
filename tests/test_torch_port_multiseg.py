"""PyTorch port: multi-segment evaluation on the CPU, against the JAX package.

* The majority vote: the port's ``majority_vote_accuracy`` against the JAX
  package's (vmapped over episodes) and the reference's host loop, exactly,
  for every tie strategy: table-driven ties and seeded random padded cases.
* The sampler: the port's test episodes against the JAX store's
  ``item_segment_rows`` / ``extract_segment`` on the same items (recovered
  from the rows, which name their item and segment): query rows, mask,
  audio ids and labels equal exactly; spectrogram padding is zeros, waveform
  padding repeats the last segment; the support's segment pick is uniform.
* One eval batch: scores of the flagship spec model (attention, 4 query
  views), the plain model (no attention, augmented queries: the vote reads
  the original view only) and a wav model against the JAX model on the same
  episode, weights and draws (within 1e-3), and the per-episode vote
  accuracies against the JAX vote tail (equal) for every tie strategy.
  Padded rows leave the real rows' scores alone.
* The eval batch rule (``tpu.eval_segment_budget``, the CPU rule the JAX
  package applies, the card's rule on given numbers) and the entry points:
  ``Trainer.test()`` and ``cli.train_test`` on a multi-segment dataset.
"""

import dataclasses
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from _torch_port_helpers import (
    GEOMETRIES, configs, exp_dict, jax_variables, jax_views, numpy_draws, torch_draws,
)
from audio_few_shot_learning_tpu import config as jcfg
from audio_few_shot_learning_tpu.data.store import PackedStore as JaxStore
from audio_few_shot_learning_tpu.data.wavstore import PackedWavStore as JaxWavStore
from audio_few_shot_learning_tpu.ops.mel import MelSpec as JaxMelSpec
from audio_few_shot_learning_tpu.train import evaluate as jeval
from audio_few_shot_learning_tpu.train.engine import Trainer as JaxTrainer
from audio_few_shot_learning_tpu_torch import config as tcfg
from audio_few_shot_learning_tpu_torch.data.episodes import sample_episode
from audio_few_shot_learning_tpu_torch.data.store import PackedStore
from audio_few_shot_learning_tpu_torch.data.wavstore import PackedWavStore
from audio_few_shot_learning_tpu_torch.train import evaluate as teval
from audio_few_shot_learning_tpu_torch.train.engine import (
    EVAL_MEMORY_SHARE, EVAL_PEAK_FACTOR, Trainer, eval_episode_bytes, multisegment_eval_batch,
)
from audio_few_shot_learning_tpu_torch.train.weights import from_jax_variables

SCORE_ATOL = 1e-3
N_WAY, K_SHOT, K_QUERY = 3, 2, 2
STRATEGIES = ("", "min_label", "max_posterior")


# ---------------------------------------------------------------------------
# the vote
# ---------------------------------------------------------------------------


def _jax_vote(preds, posts, mask, true, n_way, tie):
    fn = jax.vmap(lambda p, po, m, t: jeval.majority_vote_accuracy(p, po, m, t, n_way, tie))
    return np.asarray(fn(jnp.asarray(preds), jnp.asarray(posts), jnp.asarray(mask), jnp.asarray(true)))


def _host_vote(preds, posts, mask, true, tie):
    """The reference's loop per episode over the real segments only."""
    out = []
    for p, po, m, t in zip(preds, posts, mask, true):
        q, s = p.shape
        real = m.reshape(-1) > 0
        ids = np.repeat(np.arange(q), s)[real]
        labels = np.repeat(t, s)[real]
        out.append(teval.majority_vote_accuracy_host(p.reshape(-1)[real], ids, labels,
                                                     po.reshape(-1)[real], tie))
    return np.asarray(out, np.float32)


def _port_vote(preds, posts, mask, true, n_way, tie):
    return teval.majority_vote_accuracy(
        torch.from_numpy(preds), torch.from_numpy(posts), torch.from_numpy(mask),
        torch.from_numpy(true), n_way, tie,
    ).numpy()


# (predictions, posteriors, mask) of one query item, its label, and the vote per strategy
TIE_CASES = [
    # 2-2 tie between labels 2 and 0: first in segment order 2, smallest 0,
    # highest posterior among them 0.9 (label 0)
    ([2, 0, 2, 0], [0.5, 0.9, 0.4, 0.1], [1, 1, 1, 1], {"": 2, "min_label": 0, "max_posterior": 0}),
    # a clear majority: every strategy votes 1
    ([1, 1, 0, 2], [0.1, 0.2, 0.9, 0.95], [1, 1, 1, 1], {"": 1, "min_label": 1, "max_posterior": 1}),
    # a padded row would break the tie: padding does not vote
    ([2, 1, 1, 1], [0.3, 0.2, 0.1, 0.9], [1, 1, 0, 0], {"": 2, "min_label": 1, "max_posterior": 2}),
    # a three-way tie among the real segments: first 1, smallest 0, best posterior 0.8 (label 1)
    ([1, 2, 0, 0], [0.8, 0.1, 0.2, 0.3], [1, 1, 1, 0], {"": 1, "min_label": 0, "max_posterior": 1}),
    # one real segment
    ([2, 0, 0, 0], [0.1, 0.9, 0.9, 0.9], [1, 0, 0, 0], {"": 2, "min_label": 2, "max_posterior": 2}),
    # equal posteriors among tied segments: the first one's label
    ([0, 2, 2, 0], [0.5, 0.5, 0.5, 0.5], [1, 1, 1, 1], {"": 0, "min_label": 0, "max_posterior": 0}),
]


@pytest.mark.parametrize("tie", STRATEGIES)
def test_vote_tie_table_matches_jax_and_host(tie):
    preds = np.array([[c[0] for c in TIE_CASES]], np.int64)  # [1, Q, S]
    posts = np.array([[c[1] for c in TIE_CASES]], np.float32)
    mask = np.array([[c[2] for c in TIE_CASES]], np.float32)
    votes = [c[3][tie] for c in TIE_CASES]
    for label_shift in range(N_WAY):  # true labels each query's vote, then others
        true = (np.array([votes], np.int64) + label_shift) % N_WAY
        want = np.float32(label_shift == 0)
        got = _port_vote(preds, posts, mask, true, N_WAY, tie)
        np.testing.assert_array_equal(got, [want])
        np.testing.assert_array_equal(got, _jax_vote(preds, posts, mask, true.astype(np.int32), N_WAY, tie))
        np.testing.assert_array_equal(got, _host_vote(preds, posts, mask, true, tie))


@pytest.mark.parametrize("tie", STRATEGIES)
def test_vote_random_padded_episodes_match_jax_and_host(tie):
    rng = np.random.default_rng(0)
    e, q, s, n_way = 64, 5, 6, 4
    preds = rng.integers(0, n_way, (e, q, s))
    posts = rng.choice([0.1, 0.5, 0.7, 0.9], (e, q, s)).astype(np.float32)  # ties in posteriors too
    counts = rng.integers(1, s + 1, (e, q))
    mask = (np.arange(s) < counts[..., None]).astype(np.float32)
    true = rng.integers(0, n_way, (e, q))
    got = _port_vote(preds, posts, mask, true, n_way, tie)
    assert got.shape == (e,) and got.dtype == np.float32
    np.testing.assert_array_equal(got, _jax_vote(preds, posts, mask, true, n_way, tie))
    np.testing.assert_array_equal(got, _host_vote(preds, posts, mask, true, tie))


def test_vote_rejects_unknown_tie_strategy():
    x = torch.zeros((1, 1, 1), dtype=torch.long)
    with pytest.raises(ValueError, match="tie_strategy"):
        teval.majority_vote_accuracy(x, x.float(), x.float(), x[..., 0], 2, "max_count")


# ---------------------------------------------------------------------------
# the sampler
# ---------------------------------------------------------------------------

N_CLASSES, PER_CLASS, S_MAX, F, T = 6, 5, 4, 3, 4


def _id_spec_items(seed=0):
    """Items of 1..S_MAX segments; segment s of item i has 1000*i + s + 1 at
    [0, 0] (so a zero there is padding) and noise elsewhere."""
    rng = np.random.default_rng(seed)
    items = []
    for i in range(N_CLASSES * PER_CLASS):
        n = S_MAX if i == 0 else int(rng.integers(1, S_MAX + 1))  # item 0 sets s_max
        x = rng.standard_normal((n, F, T)).astype(np.float32)
        x[:, 0, 0] = 1000 * i + np.arange(n) + 1
        items.append(x)
    return items, np.repeat(np.arange(N_CLASSES), PER_CLASS)


def test_item_segment_rows_match_jax():
    items, labels = _id_spec_items()
    got = PackedStore.pack(items, labels, device="cpu")
    want = JaxStore.pack(items, labels)
    idx = np.arange(len(items))
    np.testing.assert_array_equal(
        got.item_segment_rows(torch.from_numpy(idx), S_MAX).numpy(),
        np.asarray(jax.vmap(lambda i: want.item_segment_rows(i, S_MAX))(jnp.asarray(idx))),
    )


def test_spec_test_episode_matches_jax_layout():
    items, labels = _id_spec_items(1)
    store = PackedStore.pack(items, labels, device="cpu")
    jstore = JaxStore.pack(items, labels)
    e = 16
    ep = sample_episode(torch.Generator().manual_seed(0), store, N_WAY, K_SHOT, K_QUERY, e, is_test=True)
    qn = N_WAY * K_QUERY
    assert ep.query.shape == (e, qn * S_MAX, F, T) and ep.support.shape == (e, N_WAY * K_SHOT, F, T)
    qry_items = ((ep.query[:, ::S_MAX, 0, 0].numpy() - 1) // 1000).astype(np.int32)  # [E, Q]
    for i in range(e):
        it = jnp.asarray(qry_items[i])
        rows = jax.vmap(lambda x: jstore.item_segment_rows(x, S_MAX))(it)
        valid = jnp.arange(S_MAX)[None, :] < jstore.seg_counts[it][:, None]
        want = jstore.segments[rows.reshape(-1)] * valid.reshape(-1)[:, None, None]
        np.testing.assert_array_equal(ep.query[i].numpy(), np.asarray(want))
        np.testing.assert_array_equal(ep.query_mask[i].numpy(), np.asarray(valid.reshape(-1), np.float32))
    np.testing.assert_array_equal(ep.audio_ids.numpy(), np.tile(np.repeat(np.arange(qn), S_MAX), (e, 1)))
    np.testing.assert_array_equal(
        ep.query_labels.numpy(), np.tile(np.repeat(np.arange(N_WAY), K_QUERY * S_MAX), (e, 1)))
    pad = ep.query_mask.numpy() == 0
    assert pad.any() and (ep.query.numpy()[pad] == 0).all()  # padding is zeros
    # every real row is a distinct segment of its item, in order
    real = ep.query[..., 0, 0].numpy().reshape(e, qn, S_MAX)
    seg = (real - 1) % 1000
    mask = ep.query_mask.numpy().reshape(e, qn, S_MAX) > 0
    np.testing.assert_array_equal(np.where(mask, seg, -1), np.where(mask, np.arange(S_MAX), -1))


def test_spec_test_episode_support_keeps_one_uniform_segment():
    """The support of a test episode keeps one uniformly random segment per item."""
    rng = np.random.default_rng(4)
    items = [rng.standard_normal((3, F, T)).astype(np.float32) for _ in range(N_CLASSES * 4)]
    for i, x in enumerate(items):
        x[:, 0, 0] = 10 * i + np.arange(3)
    store = PackedStore.pack(items, np.repeat(np.arange(N_CLASSES), 4), device="cpu")
    ep = sample_episode(torch.Generator().manual_seed(5), store, 4, 2, 2, batch=300, is_test=True)
    assert ep.support.shape == (300, 8, F, T) and ep.query.shape == (300, 8 * 3, F, T)
    seg = (ep.support[..., 0, 0].numpy().round().astype(int) % 10).ravel()
    assert scipy.stats.chisquare(np.bincount(seg, minlength=3)).pvalue > 1e-4


def test_single_segment_test_episode_leaves_mask_unset():
    store = PackedStore.pack([np.zeros((F, T), np.float32)] * 12, np.repeat(np.arange(3), 4), device="cpu")
    ep = sample_episode(torch.Generator().manual_seed(0), store, 3, 2, 2, 2, is_test=True)
    assert ep.query.shape == (2, 6, F, T) and ep.query_mask is None and ep.audio_ids is None


def _id_wav_items():
    """Clips of 1..3 one-second segments (sr 4, seg_len 4) plus a short one;
    sample value 100*i + s + 1 names item and segment."""
    rng = np.random.default_rng(2)
    items = []
    for i in range(N_CLASSES * PER_CLASS):
        n = int(rng.integers(1, 13))  # 1..12 samples: 1..3 segments, a ragged tail
        items.append((100.0 * i + np.arange(n) // 4 + 1).astype(np.float32))
    return items, np.repeat(np.arange(N_CLASSES), PER_CLASS)


def test_wav_test_episode_matches_jax_layout():
    items, labels = _id_wav_items()
    kw = dict(multi_segm=True, segment_seconds=1, sr=4)
    store = PackedWavStore.pack(items, labels, device="cpu", **kw)
    jstore = JaxWavStore.pack(items, labels, **kw)
    s_max = store.s_max
    assert s_max == 3 == jstore.s_max
    e = 16
    ep = sample_episode(torch.Generator().manual_seed(3), store, N_WAY, K_SHOT, K_QUERY, e, is_test=True)
    qn = N_WAY * K_QUERY
    assert ep.query.shape == (e, qn * s_max, 4)
    qry_items = ((ep.query[:, ::s_max, 0].numpy() - 1) // 100).astype(np.int32)
    for i in range(e):
        item_rep = jnp.repeat(jnp.asarray(qry_items[i]), s_max)
        seg_rep = jnp.tile(jnp.arange(s_max), qn)
        want = jax.vmap(jstore.extract_segment)(
            item_rep, jnp.minimum(seg_rep, jstore.seg_counts[item_rep] - 1))
        np.testing.assert_array_equal(ep.query[i].numpy(), np.asarray(want))
        np.testing.assert_array_equal(
            ep.query_mask[i].numpy(), np.asarray(seg_rep < jstore.seg_counts[item_rep], np.float32))
    np.testing.assert_array_equal(ep.audio_ids.numpy(), np.tile(np.repeat(np.arange(qn), s_max), (e, 1)))
    np.testing.assert_array_equal(
        ep.query_labels.numpy(), np.tile(np.repeat(np.arange(N_WAY), K_QUERY * s_max), (e, 1)))
    # padding repeats the item's last segment, not zeros
    rows = ep.query.numpy().reshape(e, qn, s_max, 4)
    mask = ep.query_mask.numpy().reshape(e, qn, s_max) > 0
    last = mask.sum(-1) - 1
    for i, j, s in zip(*np.nonzero(~mask)):
        np.testing.assert_array_equal(rows[i, j, s], rows[i, j, last[i, j]])
    assert (~mask).any()


# ---------------------------------------------------------------------------
# one eval batch against the JAX model and vote tail
# ---------------------------------------------------------------------------


def _multiseg_spec_store(feat_shape, seed=0, n_classes=5, per_class=5, s_max=3):
    rng = np.random.default_rng(seed)
    items = [rng.standard_normal((int(rng.integers(1, s_max + 1)),) + feat_shape).astype(np.float32)
             for _ in range(n_classes * per_class)]
    items[0] = rng.standard_normal((s_max,) + feat_shape).astype(np.float32)
    return PackedStore.pack(items, np.repeat(np.arange(n_classes), per_class), device="cpu")


def _jax_vote_tail(scores, ep, n_way, tie, s_max):
    """The JAX package's multi-segment tail (engine.py:557-567) on given scores."""
    e, qtot = ep.query.shape[:2]
    q = qtot // s_max
    scores0 = jnp.asarray(scores)[:, :qtot]
    preds = jnp.argmax(scores0, axis=-1).reshape(e, q, s_max)
    posts = jnp.max(scores0, axis=-1).reshape(e, q, s_max)
    mask = jnp.asarray(ep.query_mask.numpy()).reshape(e, q, s_max)
    true = jnp.asarray(ep.query_labels.numpy()).reshape(e, q, s_max)[:, :, 0]
    return np.asarray(jax.vmap(
        lambda p, po, m, t: jeval.majority_vote_accuracy(p, po, m, t, n_way, tie))(preds, posts, mask, true))


def _check_votes(trainer, scores, want_scores, ep, s_max, draws=None, store=None):
    np.testing.assert_allclose(scores, want_scores, atol=SCORE_ATOL, rtol=0)
    np.testing.assert_array_equal(scores.argmax(-1), want_scores.argmax(-1))
    for tie in STRATEGIES:
        with torch.inference_mode():
            acc = trainer._eval_episodes(ep, N_WAY, True, draws, store, multisegment=True,
                                         tie_strategy=tie, s_max=s_max).numpy()
        np.testing.assert_array_equal(acc, _jax_vote_tail(want_scores, ep, N_WAY, tie, s_max))
        np.testing.assert_array_equal(
            acc, Trainer.vote_accuracy(torch.tensor(want_scores), ep, N_WAY, tie, s_max).numpy())


@pytest.mark.parametrize("use_attention", [True, False], ids=["flagship", "plain-quirk"])
def test_spec_multiseg_eval_batch_matches_jax(use_attention):
    """Flagship: attention over 4 views. Without attention, with augmented
    queries, the scores hold 4 view blocks and the vote reads the first."""
    jexp, jmdl, texp, tmdl, (f, t) = configs("small", use_attention=use_attention)
    jmodel, variables = jax_variables(jexp, jmdl, (f, t), seed=51)
    store = _multiseg_spec_store((f, t))
    trainer = Trainer(texp, tmdl, store, test_store=store)
    trainer.model.load_state_dict(from_jax_variables(variables), strict=True)
    e = 2
    ep = sample_episode(torch.Generator().manual_seed(7), store, N_WAY, K_SHOT, K_QUERY, e, is_test=True)
    qtot = ep.query.shape[1]
    assert qtot == N_WAY * K_QUERY * store.s_max
    rng = np.random.default_rng(8)
    w = texp.specaug_params.W
    draws_s = numpy_draws(rng, e, N_WAY * K_SHOT, f, t, w)
    draws_q = numpy_draws(rng, e, qtot, f, t, w)
    draws = (torch_draws(draws_s), torch_draws(draws_q))
    with torch.inference_mode():
        scores = trainer._episode_scores(ep, N_WAY, True, trainer.gen, draws).numpy()
    fn = jax.jit(lambda v, s, q, lab: jmodel.apply(v, s, q, lab, N_WAY, train=False).scores)
    want = np.asarray(fn(variables, jax_views(ep.support.numpy(), draws_s),
                         jax_views(ep.query.numpy(), draws_q), ep.support_labels.numpy()))
    assert scores.shape == (e, qtot * (1 if use_attention else 4), N_WAY)
    _check_votes(trainer, scores, want, ep, store.s_max, draws)


def test_padding_leaves_real_rows_scores_alone():
    """A real row's score is the same whatever the padded rows hold, and
    without them (eval mode, BN folded, attention within an item)."""
    _, _, texp, tmdl, (f, t) = configs("small")
    store = _multiseg_spec_store((f, t), seed=3)
    trainer = Trainer(texp, tmdl, store)
    ep = sample_episode(torch.Generator().manual_seed(9), store, N_WAY, K_SHOT, K_QUERY, 1, is_test=True)
    rng = np.random.default_rng(10)
    qtot = ep.query.shape[1]
    draws_s = torch_draws(numpy_draws(rng, 1, N_WAY * K_SHOT, f, t, texp.specaug_params.W))
    draws_q = torch_draws(numpy_draws(rng, 1, qtot, f, t, texp.specaug_params.W))
    real = ep.query_mask[0] > 0
    assert not real.all()
    noisy = dataclasses.replace(ep, query=torch.where(real[:, None, None], ep.query, 5 * torch.randn_like(ep.query)))
    only = dataclasses.replace(ep, query=ep.query[:, real], query_labels=ep.query_labels[:, real])
    with torch.inference_mode():
        base = trainer._episode_scores(ep, N_WAY, True, trainer.gen, (draws_s, draws_q))
        with_noise = trainer._episode_scores(noisy, N_WAY, True, trainer.gen, (draws_s, draws_q))
        draws_only = (draws_q[0][:, real], draws_q[1], draws_q[2])
        without = trainer._episode_scores(only, N_WAY, True, trainer.gen, (draws_s, draws_only))
    torch.testing.assert_close(with_noise[:, real], base[:, real], atol=1e-5, rtol=0)
    torch.testing.assert_close(without, base[:, real], atol=1e-5, rtol=0)


MEAN, STD = -20.0, 15.0


def test_wav_multiseg_eval_batch_matches_jax():
    """Wav: 1-s segments of clips of 0.4-3 s (128x32 log-mels, the "wav"
    test geometry), one online log-mel call, z-norm, the model, the vote."""
    e_dict = exp_dict(input_type="wav", waveaug_params={"use": False}, multi_segm=True)
    mdl = GEOMETRIES["wav"][1]
    jexp, jmdl = jcfg.ExperimentConfig.from_dict(e_dict), jcfg.ModelConfig.from_dict(mdl)
    texp, tmdl = tcfg.ExperimentConfig.from_dict(e_dict), tcfg.ModelConfig.from_dict(mdl)
    jmodel, variables = jax_variables(jexp, jmdl, GEOMETRIES["wav"][0], seed=61)
    rng = np.random.default_rng(11)
    clips = [(0.3 * rng.standard_normal(int(rng.integers(6400, 48000)))).astype(np.float32)
             for _ in range(25)]
    store = PackedWavStore.pack(clips, np.repeat(np.arange(5), 5), mean=MEAN, std=STD,
                                multi_segm=True, segment_seconds=1, device="cpu")
    assert store.s_max == 3
    trainer = Trainer(texp, tmdl, store, test_store=store)
    trainer.model.load_state_dict(from_jax_variables(variables), strict=True)
    e = 2
    ep = sample_episode(torch.Generator().manual_seed(12), store, N_WAY, K_SHOT, K_QUERY, e, is_test=True)
    with torch.inference_mode():
        scores = trainer._episode_scores(ep, N_WAY, True, trainer.gen, store=store).numpy()
    sup, qry = ep.support.numpy(), ep.query.numpy()
    flat = np.concatenate([sup, qry], axis=1).reshape(-1, sup.shape[-1])
    mels = (JaxMelSpec(flavor="online", use_pallas=False)(jnp.asarray(flat)) - MEAN) / STD
    mels = mels.reshape(e, -1, 1, *mels.shape[-2:])
    s = sup.shape[1]
    fn = jax.jit(lambda v, a, b, lab: jmodel.apply(v, a, b, lab, N_WAY, train=False).scores)
    want = np.asarray(fn(variables, mels[:, :s], mels[:, s:], jnp.asarray(ep.support_labels.numpy())))
    _check_votes(trainer, scores, want, ep, store.s_max, store=store)


# ---------------------------------------------------------------------------
# the eval batch rule
# ---------------------------------------------------------------------------


def test_explicit_segment_budget_wins():
    for budget, s_max, want in ((36, 6, 6), (36, 36, 1), (5, 6, 1), (0, 6, 1), (400, 6, 16)):
        assert multisegment_eval_batch(16, s_max, 10**9, 80 * 10**9, 128 * 157, budget) == want


def test_cpu_rule_batches_as_the_jax_package():
    """No memory to read: the JAX package's rule, for spec and wav row sizes."""
    for feat_shape, s_max in (((128, 157), 6), ((128, 157), 36), ((96, 99), 3), ((80000,), 6), ((16000,), 3)):
        fake = types.SimpleNamespace(exp=jcfg.ExperimentConfig.from_dict({}))
        store = types.SimpleNamespace(feat_shape=feat_shape, s_max=s_max)
        seg_budget = JaxTrainer._eval_segment_budget(fake, store)
        for batch in (1, 4, 16):
            want = max(1, min(batch, seg_budget // s_max))
            got = multisegment_eval_batch(batch, s_max, 1, None, int(np.prod(feat_shape)))
            assert got == want, (feat_shape, s_max, batch)


def test_card_rule_from_free_memory_and_episode_bytes():
    gb = 10**9
    mb_per_item = 64 * 128 * 157 * 2  # block 0's bf16 output of one encoder item, 2.57 MB
    cases = {  # (S, Q*s_max, views of each): encoder items per episode
        "flagship s_max 6": (25, 150, 4, 4, 700),
        "flagship s_max 36": (25, 900, 4, 4, 3700),
        "plain s_max 36": (25, 900, 1, 1, 925),
    }
    for s, qrows, vs, vq, items in cases.values():
        assert eval_episode_bytes(s, qrows, vs, vq, mb_per_item) == items * mb_per_item
    assert eval_episode_bytes(25, 150, 1, 1, 2 * mb_per_item) == 175 * 2 * mb_per_item
    # an item's bytes, as the conv encoders give them: block 0's channels x F x T in the compute dtype
    from audio_few_shot_learning_tpu_torch.models.encoders import make_backbone

    for name in ("Hybrid", "CNN"):
        for dtype, itemsize in (("float32", 4), ("bfloat16", 2)):
            enc = make_backbone(name, tcfg.CNNConfig(), tcfg.HybridConfig(), (128, 157), dtype).encoder
            assert enc.eval_item_bytes == 64 * 128 * 157 * itemsize, (name, dtype)
    assert mb_per_item == make_backbone("Hybrid", tcfg.CNNConfig(), tcfg.HybridConfig(), (128, 157)).encoder.\
        eval_item_bytes
    episode = 700 * mb_per_item  # 1.80 GB
    free = 70 * gb
    want = int(EVAL_MEMORY_SHARE * free // (EVAL_PEAK_FACTOR * episode))
    assert multisegment_eval_batch(64, 6, episode, free, 128 * 157) == min(64, want)
    assert multisegment_eval_batch(2, 6, episode, free, 128 * 157) == 2  # never above the batch asked
    assert multisegment_eval_batch(16, 36, 3700 * mb_per_item, 1 * gb, 128 * 157) == 1  # at least one


def test_trainer_eval_batch_on_the_cpu():
    _, _, texp, tmdl, feat_shape = configs("small")
    store = _multiseg_spec_store(feat_shape)
    over = dataclasses.replace(texp, tpu=dataclasses.replace(texp.tpu, eval_episode_batch=16))
    trainer = Trainer(over, tmdl, store)
    assert trainer.eval_batch_size(store, 64, N_WAY, K_SHOT, K_QUERY, True, False) == 16
    seg_budget = int(36 * 128 * 157 / (96 * 99))
    assert trainer.eval_batch_size(store, 64, N_WAY, K_SHOT, K_QUERY, True, True) == min(16, seg_budget // 3)
    assert trainer.eval_batch_size(store, 2, N_WAY, K_SHOT, K_QUERY, True, True) == 2
    budget = dataclasses.replace(over, tpu=dataclasses.replace(over.tpu, eval_segment_budget=7))
    assert Trainer(budget, tmdl, store).eval_batch_size(store, 64, N_WAY, K_SHOT, K_QUERY, True, True) == 2


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def _synth(tmp_path, **kw):
    from audio_few_shot_learning_tpu_torch.data.datasets import make_synthetic_dataset

    return make_synthetic_dataset(tmp_path / "synth", n_classes=9, items_per_class=5, n_mels=96,
                                  n_frames=99, multi_segm=True, max_segments=3,
                                  split_fractions=(3, 3, 3), **kw)


def test_test_runs_the_vote_on_a_multisegment_split(tmp_path):
    from audio_few_shot_learning_tpu_torch.data.datasets import load_packed_split

    root = _synth(tmp_path)
    _, _, texp, tmdl, _ = configs("small")
    for tie in STRATEGIES:
        exp = dataclasses.replace(texp, multi_segm=True, tie_strategy=tie, n_testing_tasks=3)
        store = load_packed_split(exp, root, "test", "cpu")
        assert store.multi_segm and store.s_max > 1
        trainer = Trainer(exp, tmdl, store, test_store=store, seed=1)
        out = trainer.test()
        assert 0.0 <= out["mean_accuracy"] <= 1.0 and out["accuracy_std"] >= 0.0
        assert trainer.last_eval_batch == 2  # eval_episode_batch 2, within the CPU rule
    with pytest.raises(ValueError, match="tie_strategy"):
        trainer.evaluate(store, 2, N_WAY, K_SHOT, K_QUERY, True, multisegment=True, tie_strategy="mode")


def test_train_test_cli_runs_a_multisegment_config(tmp_path):
    from audio_few_shot_learning_tpu_torch.cli import train_test

    _synth(tmp_path)
    d = exp_dict(multi_segm=True, tie_strategy="max_posterior", dataset_name="synth",
                 data_root=str(tmp_path), n_training_tasks=2, n_testing_tasks=3, num_epochs=1,
                 experiment_folder="run", n_way_train=N_WAY, n_shot_train=K_SHOT, n_query_train=K_QUERY,
                 n_way_validation=N_WAY, n_shot_validation=K_SHOT, n_query_validation=K_QUERY,
                 train_query_augmentations=True, validation_query_augmentations=True)
    d["tpu"]["num_runs"] = 1
    (tmp_path / "exp.json").write_text(json.dumps(d))
    (tmp_path / "mdl.json").write_text(json.dumps(GEOMETRIES["small"][1]))
    results = train_test.main(["-e", str(tmp_path / "exp.json"), "-m", str(tmp_path / "mdl.json"),
                               "--experiments-root", str(tmp_path / "experiments")])
    out = json.loads((tmp_path / "experiments" / "run" / "result_run0.json").read_text())
    assert out == results[0] and 0.0 <= out["mean_accuracy"] <= 1.0
