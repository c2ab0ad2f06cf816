"""PyTorch port: packed store and single-segment episodic sampler.

Samplers are compared by distribution, not draw for draw (JAX keys and torch
generators never agree): shapes, the ascending class remap, no item twice in
an episode, chi-square tests of class and ordered-tuple frequencies, as the
JAX package's tests/test_data.py does. The packed store is compared with the
JAX store bit for bit.
"""

import ml_dtypes
import numpy as np
import pytest
import scipy.stats
import torch

from audio_few_shot_learning_tpu.data.store import PackedStore as JaxStore
from audio_few_shot_learning_tpu_torch.data.episodes import floyd_sample, sample_episode
from audio_few_shot_learning_tpu_torch.data.store import PackedStore

N_CLASSES, PER_CLASS, F, T = 8, 6, 3, 4


def _id_store(counts=None):
    """Item i's spec is filled with the value i, so a sampled row names its item."""
    counts = counts or [PER_CLASS] * N_CLASSES
    labels = np.repeat(np.arange(len(counts)), counts)
    items = [np.full((F, T), i, np.float32) for i in range(len(labels))]
    return PackedStore.pack(items, labels, len(counts), device="cpu"), labels


def _items(x):
    return x[..., 0, 0].long().numpy()


def test_episode_shapes_labels_and_sorted_classes():
    store, labels = _id_store()
    e, n_way, ks, kq = 64, 3, 2, 2
    ep = sample_episode(torch.Generator().manual_seed(0), store, n_way, ks, kq, batch=e)
    assert ep.support.shape == (e, n_way * ks, F, T)
    assert ep.query.shape == (e, n_way * kq, F, T)
    np.testing.assert_array_equal(ep.support_labels[0].numpy(), [0, 0, 1, 1, 2, 2])
    np.testing.assert_array_equal(ep.query_labels[0].numpy(), [0, 0, 1, 1, 2, 2])
    sup, qry = _items(ep.support), _items(ep.query)
    for i in range(e):
        sup_cls = labels[sup[i]].reshape(n_way, ks)
        qry_cls = labels[qry[i]].reshape(n_way, kq)
        assert (sup_cls == sup_cls[:, :1]).all() and (qry_cls == sup_cls[:, :1]).all()
        assert (np.diff(sup_cls[:, 0]) > 0).all()  # remap = ascending class order
        both = np.concatenate([sup[i], qry[i]])
        assert len(set(both.tolist())) == len(both)  # no item twice


def test_class_frequencies_uniform():
    store, labels = _id_store()
    ep = sample_episode(torch.Generator().manual_seed(1), store, 2, 1, 1, batch=600)
    counts = np.bincount(labels[_items(ep.support).ravel()], minlength=N_CLASSES)
    assert scipy.stats.chisquare(counts).pvalue > 1e-4, counts


def test_classes_with_too_few_items_excluded():
    store, labels = _id_store([PER_CLASS, 2, PER_CLASS, PER_CLASS, 3, PER_CLASS])
    ep = sample_episode(torch.Generator().manual_seed(2), store, 3, 2, 2, batch=200)
    drawn = set(labels[_items(ep.support).ravel()].tolist())
    assert drawn == {0, 2, 3, 5}


def test_floyd_sample_uniform_ordered_tuples():
    k, count, trials = 3, 6, 7200
    draws = floyd_sample(
        torch.Generator().manual_seed(3), torch.full((trials,), count), k
    ).numpy()
    assert draws.min() >= 0 and draws.max() < count
    assert all(len(set(d.tolist())) == k for d in draws)
    ids = draws[:, 0] * count * count + draws[:, 1] * count + draws[:, 2]
    observed = np.bincount(ids, minlength=count**3)
    valid = observed[observed.nonzero()]
    assert valid.size == 120  # every ordered 3-of-6 tuple occurs
    assert scipy.stats.chisquare(valid).pvalue > 1e-4


def test_segment_pick_uniform():
    """One uniformly random segment per item among its real segments."""
    rng = np.random.default_rng(4)
    items = [rng.standard_normal((3, F, T)).astype(np.float32) for _ in range(N_CLASSES * 4)]
    for i, x in enumerate(items):
        x[:, 0, 0] = 10 * i + np.arange(3)  # row names item and segment
    store = PackedStore.pack(items, np.repeat(np.arange(N_CLASSES), 4), N_CLASSES, device="cpu")
    ep = sample_episode(torch.Generator().manual_seed(5), store, 4, 2, 2, batch=300)
    seg = (ep.support[..., 0, 0].numpy().round().astype(int) % 10).ravel()
    counts = np.bincount(seg, minlength=3)
    assert scipy.stats.chisquare(counts).pvalue > 1e-4, counts


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pack_matches_jax_store(dtype):
    rng = np.random.default_rng(6)
    items = [rng.standard_normal((2, F, T) if i % 3 == 0 else (F, T)).astype(np.float32)
             for i in range(10)]
    labels = [0, 1, 2, 0, 1, 2, 0, 1, 2, 2]
    want = JaxStore.pack(items, labels, mean=0.3, std=1.7, dtype=dtype)
    got = PackedStore.pack(items, labels, mean=0.3, std=1.7, dtype=dtype, device="cpu")
    want_seg = np.asarray(want.segments)
    if dtype == "bfloat16":
        want_seg = want_seg.astype(ml_dtypes.bfloat16).view(np.uint16)
        np.testing.assert_array_equal(got.segments.view(torch.int16).numpy().view(np.uint16), want_seg)
    else:
        np.testing.assert_array_equal(got.segments.numpy(), want_seg)
    for name in ("seg_offsets", "seg_counts", "labels", "class_table", "class_counts"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)), name)
    assert (got.n_classes, got.s_max, got.multi_segm) == (want.n_classes, want.s_max, want.multi_segm)
    idx = torch.tensor([4, 7])
    np.testing.assert_array_equal(
        got.get_segment(idx, torch.tensor([0, 0])).float().numpy(),
        np.asarray(want.segments).astype(np.float32)[np.asarray(want.seg_offsets)[[4, 7]]],
    )
