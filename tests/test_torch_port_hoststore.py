"""PyTorch port: host-resident streaming on the CPU, against the JAX package.

* ``HostStore.pack`` / ``from_flat_arrays`` (float32 and bfloat16, the
  bfloat16 bits against ml_dtypes') and ``WavHostStore.pack`` /
  ``pack_from_files`` (float32 and float16) equal the JAX stores bit for bit.
* ``sample_episode_batch`` on one ``np.random.default_rng(seed)`` gives the
  JAX package's episodes, every field exactly: single segment, train
  episodes of a multi-segment store, multi-segment test episodes with
  padding and mask, E = 1 and 4, spec and wav.
* ``load_packed_split`` routes as the JAX package does (forced either way,
  or by size with the card's memory given), and sends a wav split past the
  device store's int32 addressing to the host store.
* The staging (``data/staging.py``) on the CPU: the batch it hands over is
  the sampler's, in two alternating buffers.
* The engine: a host-fed train step equals the device-fed one on the same
  episode and draws; a host-fed eval batch equals the JAX package's
  ``Trainer._eval_episodes`` on the same episode (scores within 1e-3, the
  accuracies and votes equal); the same seed replays the same losses;
  resume replays epoch 2's episode stream; ``test()`` single and
  multi-segment, ``validate`` and ``predict_episode`` run on host stores.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from _torch_port_helpers import GEOMETRIES, configs, exp_dict, jax_variables, jax_views, numpy_draws, torch_draws
from audio_few_shot_learning_tpu.data.episodes import EpisodeBatch as JaxEpisodeBatch
from audio_few_shot_learning_tpu.data.hoststore import HostStore as JaxHostStore
from audio_few_shot_learning_tpu.data.wavhoststore import WavHostStore as JaxWavHostStore
from audio_few_shot_learning_tpu.train.engine import Trainer as JaxTrainer
from audio_few_shot_learning_tpu_torch import config as tcfg
from audio_few_shot_learning_tpu_torch.data import datasets
from audio_few_shot_learning_tpu_torch.data.hoststore import HostStore
from audio_few_shot_learning_tpu_torch.data.staging import EpisodeStager
from audio_few_shot_learning_tpu_torch.data.store import PackedStore
from audio_few_shot_learning_tpu_torch.data.wavhoststore import WavHostStore
from audio_few_shot_learning_tpu_torch.data.wavstore import PackedWavStore
from audio_few_shot_learning_tpu_torch.train.engine import Trainer, TrainDraws
from audio_few_shot_learning_tpu_torch.train.weights import from_jax_variables

N_WAY, K_SHOT, K_QUERY = 3, 2, 2
FIELDS = ("support", "support_labels", "query", "query_labels", "audio_ids", "query_mask")
SCORE_ATOL = 1e-3


def _items(rng, n, shape, s_max):
    return [rng.standard_normal((int(rng.integers(1, s_max + 1)),) + shape).astype(np.float32)
            if s_max > 1 else rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def _clips(rng, n, lo=3000, hi=40000):
    clips = [(0.3 * rng.standard_normal(int(rng.integers(lo, hi)))).astype(np.float32) for _ in range(n)]
    clips[3] = np.zeros(0, np.float32)  # an empty item keeps its own silent row
    return clips


def _bits(x):
    """Comparable numpy bits of a numpy or torch array (bfloat16 as int16)."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 else x.numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype == ml_dtypes.bfloat16 else x


def _assert_same_episodes(want, got, upcast=False):
    for f in FIELDS:
        a, b = getattr(want, f), getattr(got, f)
        if upcast and f in ("support", "query"):
            b = b.float()
        assert tuple(np.shape(a)) == tuple(b.shape), f
        np.testing.assert_array_equal(_bits(b), _bits(a), err_msg=f)


# ---------------------------------------------------------------------------
# packing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_host_store_packs_as_jax(dtype):
    rng = np.random.default_rng(0)
    items = _items(rng, 24, (8, 6), 3)
    labels = np.repeat(np.arange(6), 4)
    want = JaxHostStore.pack(items, labels, mean=0.3, std=1.7, dtype=dtype)
    got = HostStore.pack(items, labels, mean=0.3, std=1.7, dtype=dtype)
    np.testing.assert_array_equal(_bits(got.segments), _bits(want.segments))
    flat = HostStore.from_flat_arrays(np.asarray(want.segments).astype(np.float32), want.seg_counts, labels, 6,
                                      dtype=dtype)
    np.testing.assert_array_equal(_bits(flat.segments), _bits(want.segments))
    for store in (got, flat):
        np.testing.assert_array_equal(store.seg_counts, want.seg_counts)
        np.testing.assert_array_equal(store.seg_offsets, want.seg_offsets)
        np.testing.assert_array_equal(store.class_counts, want.class_counts)
        assert (store.s_max, store.multi_segm, store.num_items, store.nbytes()) == \
            (want.s_max, want.multi_segm, want.num_items, want.nbytes())
        assert store.feat_shape == want.feat_shape and store.is_host_resident


@pytest.mark.parametrize("dtype", ["float32", "float16"])
@pytest.mark.parametrize("multi_segm", [False, True])
def test_wav_host_store_packs_as_jax(tmp_path, dtype, multi_segm):
    rng = np.random.default_rng(1)
    clips = _clips(rng, 20)
    labels = np.repeat(np.arange(4), 5)
    paths = []
    for i, c in enumerate(clips):  # one float64 file: converted to float32 first, as there
        paths.append(tmp_path / f"{i}.npy")
        np.save(paths[-1], c.astype(np.float64) if i == 5 else c)
    kw = dict(mean=-20.0, std=15.0, multi_segm=multi_segm, segment_seconds=1, dtype=dtype)
    want = JaxWavHostStore.pack(clips, labels, **kw)
    for got in (WavHostStore.pack(clips, labels, **kw), WavHostStore.pack_from_files(paths, labels, **kw)):
        assert got.dtype == (torch.float16 if dtype == "float16" else torch.float32)
        np.testing.assert_array_equal(got.flat.numpy(), want.flat)
        np.testing.assert_array_equal(got.tails.numpy(), want.tails)
        for name in ("offsets", "lengths", "tail_index", "seg_counts", "class_counts"):
            np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
        assert (got.seg_len, got.s_max, got.nbytes(), got.mean, got.std) == \
            (want.seg_len, want.s_max, want.nbytes(), want.mean, want.std)
    assert WavHostStore.pack(clips, labels, dtype="bfloat16").dtype == torch.float16  # as there


# ---------------------------------------------------------------------------
# the host sampler
# ---------------------------------------------------------------------------

SAMPLER_CASES = {  # name -> (store s_max, is_test)
    "single": (1, False),
    "multiseg_train": (3, False),
    "multiseg_test": (3, True),
}


@pytest.mark.parametrize("e", [1, 4])
@pytest.mark.parametrize("case", list(SAMPLER_CASES))
@pytest.mark.parametrize("kind", ["spec_f32", "spec_bf16", "wav_f32", "wav_f16"])
def test_sampler_matches_jax(kind, case, e):
    """The same Generator gives the JAX package's episodes, every field
    exactly (the port's rows in the store's dtype, float16 upcast here)."""
    s_max, is_test = SAMPLER_CASES[case]
    rng = np.random.default_rng(2)
    labels = np.repeat(np.arange(5), 5)
    if kind.startswith("spec"):
        dtype = "bfloat16" if kind.endswith("bf16") else "float32"
        items = _items(rng, 25, (8, 6), s_max)
        want_store = JaxHostStore.pack(items, labels, mean=0.1, std=2.0, dtype=dtype)
        got_store = HostStore.pack(items, labels, mean=0.1, std=2.0, dtype=dtype)
    else:
        dtype = "float16" if kind.endswith("f16") else "float32"
        clips = _clips(rng, 25, 3000, 8000 * s_max)
        kw = dict(multi_segm=s_max > 1, segment_seconds=1, sr=4000 if s_max > 1 else 16000, dtype=dtype)
        want_store, got_store = JaxWavHostStore.pack(clips, labels, **kw), WavHostStore.pack(clips, labels, **kw)
    assert got_store.s_max == want_store.s_max and (got_store.s_max > 1) == (s_max > 1)
    want = want_store.sample_episode_batch(np.random.default_rng(9), N_WAY, K_SHOT, K_QUERY, is_test, e)
    got = got_store.sample_episode_batch(np.random.default_rng(9), N_WAY, K_SHOT, K_QUERY, is_test, e)
    _assert_same_episodes(want, got, upcast=kind.startswith("wav"))
    if case == "multiseg_test":
        assert (got.query_mask == 0).any()  # padding exercised
        if kind.startswith("spec"):
            assert (got.query.float()[got.query_mask == 0] == 0).all()


def test_staging_on_the_cpu_hands_over_the_sampled_batch():
    """Staged batches equal the sampler's (labels made once per layout),
    and alternate between two buffers, the third reusing the first's."""
    rng = np.random.default_rng(3)
    store = HostStore.pack(_items(rng, 25, (8, 6), 3), np.repeat(np.arange(5), 5), dtype="bfloat16")
    stager = EpisodeStager("cpu")
    gen_a, gen_b = np.random.default_rng(4), np.random.default_rng(4)
    ptrs = []
    for is_test in (True, False, True):
        ep = stager.stage(store, store.plan(gen_a, N_WAY, K_SHOT, K_QUERY, is_test, 2))
        want = store.sample_episode_batch(gen_b, N_WAY, K_SHOT, K_QUERY, is_test, 2)
        for f in FIELDS:
            if getattr(ep, f) is None:  # single-segment batches leave ids and mask unset
                assert not is_test and f in ("audio_ids", "query_mask")
                continue
            np.testing.assert_array_equal(_bits(getattr(ep, f)), _bits(getattr(want, f)), err_msg=f)
        ptrs.append(ep.support.data_ptr())
    assert ptrs[0] == ptrs[2] != ptrs[1] and stager.h2d_bytes == 0


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------


def _spec_dataset(tmp_path):
    return datasets.make_synthetic_dataset(tmp_path / "spec", n_classes=6, items_per_class=4, n_mels=8,
                                           n_frames=6, split_fractions=(2, 2, 2))


def _with(exp, **tpu):
    return dataclasses.replace(exp, tpu=dataclasses.replace(exp.tpu, **tpu))


def test_load_packed_split_routes_as_jax(tmp_path, monkeypatch):
    root = _spec_dataset(tmp_path)
    exp = tcfg.ExperimentConfig.from_dict({"device": "cpu"})
    assert isinstance(datasets.load_packed_split(_with(exp, host_store=True), root, "valid", "cpu"), HostStore)
    assert isinstance(datasets.load_packed_split(_with(exp, host_store=False), root, "valid", "cpu"), PackedStore)
    est = datasets.MetaAudioDataset(exp, root, "valid").estimated_packed_bytes("float32")
    auto = _with(exp, host_store=None)
    for memory, want in ((None, PackedStore), (int(est / 0.5), PackedStore), (est, HostStore)):
        monkeypatch.setattr(datasets, "_device_memory_bytes", lambda device, m=memory: m)
        assert isinstance(datasets.load_packed_split(auto, root, "valid", "cpu"), want), memory
    monkeypatch.setattr(datasets, "_device_memory_bytes", lambda device: 1)
    assert isinstance(datasets.load_packed_split(_with(exp, host_store=False), root, "valid", "cpu"), PackedStore)
    host = datasets.load_packed_split(_with(exp, host_store=True, store_dtype="bfloat16"), root, "valid", "cpu")
    assert host.segments.dtype == torch.bfloat16


def _wav_dataset(tmp_path, n_classes=6, per_class=4, seconds=0.5):
    root = tmp_path / "wav"
    rng = np.random.default_rng(5)
    names = [f"c{i}" for i in range(n_classes)]
    for name in names:
        (root / "waveforms_npy" / name).mkdir(parents=True)
        for i in range(per_class):
            n = int(16000 * seconds * (0.5 + rng.random()))
            np.save(root / "waveforms_npy" / name / f"{i}.npy", (0.3 * rng.standard_normal(n)).astype(np.float32))
    (root / "norm_stats").mkdir()
    np.save(root / "norm_stats" / "glob_norm.npy", np.array([[[-20.0]], [[15.0]]], np.float32))
    third = n_classes // 3
    np.save(root / "splits.npy", np.array([np.array(names[i * third:(i + 1) * third], dtype=object)
                                           for i in range(3)], dtype=object), allow_pickle=True)
    return root


def test_wav_split_past_int32_addressing_goes_to_the_host_store(tmp_path, monkeypatch):
    """The repair: under ``host_store: null`` a wav split whose samples pass
    the device store's int32 addressing loads as a WavHostStore, where the
    device store would raise; forced to the card it still raises, naming
    the route."""
    root = _wav_dataset(tmp_path)
    exp = tcfg.ExperimentConfig.from_dict({"device": "cpu", "input_type": "wav", "multi_segm": True})
    ds = datasets.MetaAudioDataset(exp, root, "valid")
    samples = sum(np.load(p).shape[0] for p in ds.filepaths)
    assert samples <= ds.estimated_samples() < samples + 40 * len(ds.filepaths)  # the headers
    assert isinstance(datasets.load_packed_split(exp, root, "valid", "cpu"), PackedWavStore)
    monkeypatch.setattr(datasets, "MAX_DEVICE_SAMPLES", samples // 2)
    store = datasets.load_packed_split(exp, root, "valid", "cpu")
    assert isinstance(store, WavHostStore) and store.dtype == torch.float32
    half = datasets.load_packed_split(_with(exp, store_dtype="bfloat16"), root, "valid", "cpu")
    assert half.dtype == torch.float16
    import audio_few_shot_learning_tpu_torch.data.wavstore as wavstore

    monkeypatch.setattr(wavstore, "MAX_DEVICE_SAMPLES", samples // 2)
    with pytest.raises(ValueError, match="WavHostStore, where load_packed_split sends it"):
        datasets.load_packed_split(_with(exp, host_store=False), root, "valid", "cpu")


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


def _train_dict(**over):
    d = exp_dict(n_way_train=N_WAY, n_shot_train=K_SHOT, n_query_train=K_QUERY, n_way_validation=N_WAY,
                 n_shot_validation=K_SHOT, n_query_validation=K_QUERY, n_training_tasks=2, lr=1e-3,
                 loss={"l_param": 1.5, "cpl": {"use": True, "m_param": K_QUERY, "t_param": 2.0}},
                 train_query_augmentations=True, validation_query_augmentations=True, n_testing_tasks=3)
    d["tpu"].update(episode_batch=2)
    d.update(over)
    return d


def _spec_stores(geometry="fprime", s_max=1, seed=6):
    feat_shape = GEOMETRIES[geometry][0]
    rng = np.random.default_rng(seed)
    items = _items(rng, 20, feat_shape, s_max)
    labels = np.repeat(np.arange(5), 4)
    return HostStore.pack(items, labels), PackedStore.pack(items, labels, device="cpu")


def _trainer(store, geometry="fprime", seed=3, **over):
    d = _train_dict(**over)
    return Trainer(tcfg.ExperimentConfig.from_dict(d), tcfg.ModelConfig.from_dict(GEOMETRIES[geometry][1]),
                   store, val_store=store, test_store=store, seed=seed)


def test_hostfed_train_step_equals_device_fed():
    """The staged batch of a host store through ``train_step`` gives the
    device-fed step's metrics and parameters, to the bit, on the same
    episode and TrainDraws (dropout from equal generators)."""
    host, packed = _spec_stores()
    a, b = _trainer(host), _trainer(packed)
    assert a.host_mode and not b.host_mode
    b.model.load_state_dict(a.model.state_dict())
    plan = host.plan(np.random.default_rng(7), N_WAY, K_SHOT, K_QUERY, False, 2)
    ep_host = a.stager.stage(host, plan)
    ep_dev = host.sample_episode_batch(np.random.default_rng(7), N_WAY, K_SHOT, K_QUERY, False, 2)
    ep_dev = dataclasses.replace(ep_dev, audio_ids=None, query_mask=None)
    f, t = GEOMETRIES["fprime"][0]
    rng = np.random.default_rng(8)
    d = TrainDraws(support=torch_draws(numpy_draws(rng, 2, N_WAY * K_SHOT, f, t, 6)),
                   query=torch_draws(numpy_draws(rng, 2, N_WAY * K_QUERY, f, t, 6)),
                   perms=torch.from_numpy(np.stack([rng.permutation(3) + 1 for _ in range(2)])))
    ma, mb = a.train_step(ep_host, d), b.train_step(ep_dev, d)
    torch.testing.assert_close(ma, mb, atol=0, rtol=0)
    for (name, pa), pb in zip(a.model.named_parameters(), b.model.parameters()):
        torch.testing.assert_close(pa, pb, atol=0, rtol=0, msg=name)


def _jax_eval_episodes(jexp, jmodel, variables, ep, views, n_way, multisegment, tie, s_max):
    """The JAX package's ``Trainer._eval_episodes`` on an episode given as
    numpy, the views given as data (``views`` in call order: support, query)."""
    fake = types.SimpleNamespace(exp=jexp, is_wav=False, specaug=True, model=jmodel,
                                 _shard_episodes=lambda e: e)
    fake._v_query = lambda aq: JaxTrainer._v_query(fake, aq)
    views = list(views)
    fake._make_views = lambda specs, key, enabled: jnp.asarray(views.pop(0))
    jep = JaxEpisodeBatch(**{f: jnp.asarray(np.asarray(getattr(ep, f))) for f in FIELDS})
    run = jax.jit(lambda v, e: JaxTrainer._eval_episodes(
        fake, types.SimpleNamespace(**v), e, jax.random.PRNGKey(0), n_way, True, multisegment, tie, s_max))
    return np.asarray(run(variables, jep))


@pytest.mark.parametrize("multisegment", [False, True], ids=["single", "multiseg"])
def test_hostfed_eval_batch_matches_jax(multisegment):
    """One staged eval batch of a host store against JAX
    ``_eval_episodes`` on the JAX host store's episode from the same
    Generator: scores within 1e-3, the accuracies (every tie strategy for
    the vote) equal."""
    jexp, jmdl, texp, tmdl, (f, t) = configs("small")
    jmodel, variables = jax_variables(jexp, jmdl, (f, t), seed=31)
    rng = np.random.default_rng(10)
    items = _items(rng, 25, (f, t), 3 if multisegment else 1)
    labels = np.repeat(np.arange(5), 5)
    host, jhost = HostStore.pack(items, labels), JaxHostStore.pack(items, labels)
    trainer = Trainer(texp, tmdl, host, test_store=host)
    trainer.model.load_state_dict(from_jax_variables(variables), strict=True)
    e = 2
    ep = trainer.stager.stage(host, host.plan(np.random.default_rng(11), N_WAY, K_SHOT, K_QUERY, multisegment, e))
    jep = jhost.sample_episode_batch(np.random.default_rng(11), N_WAY, K_SHOT, K_QUERY, multisegment, e)
    np.testing.assert_array_equal(ep.query.numpy(), np.asarray(jep.query))
    qtot = ep.query.shape[1]
    w = texp.specaug_params.W
    draws_s, draws_q = numpy_draws(rng, e, N_WAY * K_SHOT, f, t, w), numpy_draws(rng, e, qtot, f, t, w)
    views = (jax_views(np.asarray(jep.support), draws_s), jax_views(np.asarray(jep.query), draws_q))
    draws = (torch_draws(draws_s), torch_draws(draws_q))
    with torch.inference_mode():
        scores = trainer._episode_scores(ep, N_WAY, True, trainer.gen, draws).numpy()
    fn = jax.jit(lambda v, s, q, lab: jmodel.apply(v, s, q, lab, N_WAY, train=False).scores)
    want = np.asarray(fn(variables, *views, np.asarray(jep.support_labels)))
    np.testing.assert_allclose(scores, want, atol=SCORE_ATOL, rtol=0)
    np.testing.assert_array_equal(scores.argmax(-1), want.argmax(-1))
    for tie in (("", "min_label", "max_posterior") if multisegment else ("",)):
        with torch.inference_mode():
            acc = trainer._eval_episodes(ep, N_WAY, True, draws, multisegment=multisegment, tie_strategy=tie,
                                         s_max=host.s_max).numpy()
        np.testing.assert_array_equal(
            acc, _jax_eval_episodes(jexp, jmodel, variables, jep, views, N_WAY, multisegment, tie, host.s_max))


def test_hostfed_replay_and_entry_points():
    """The same seed replays the same host-fed losses and accuracies;
    ``test()``, ``validate`` and a multi-segment ``test()`` run on host
    stores, with the eval batch the device store's rule gives."""
    host, _ = _spec_stores()
    a, b = _trainer(host, seed=5), _trainer(host, seed=5)
    ma, mb = a.train_epoch(), b.train_epoch()
    assert ma == {**mb, "episodes_per_sec": ma["episodes_per_sec"]} and np.isfinite(ma["loss"])
    assert a.validate() == b.validate() and 0.0 <= a.test()["mean_accuracy"] <= 1.0
    assert a.last_eval_batch == 2 and a.step == 1
    multi, packed = _spec_stores(s_max=3)
    m = _trainer(multi, multi_segm=True, tie_strategy="max_posterior")
    out = m.test()
    assert 0.0 <= out["mean_accuracy"] <= 1.0 and multi.multi_segm
    assert m.last_eval_batch == _trainer(packed, multi_segm=True).eval_batch_size(
        packed, 3, N_WAY, K_SHOT, K_QUERY, True, True)


def test_hostfed_resume_replays_epoch_two(tmp_path):
    """2 host-fed epochs straight equal 1 epoch, a resume checkpoint, a
    fresh trainer resumed from it and 1 more: the host Generator of epoch 2
    comes from the checkpointed generator, so the same episodes, losses,
    validation and weights, to the bit."""
    from audio_few_shot_learning_tpu_torch.train.experiment import run_single_training

    host, _ = _spec_stores()
    logs = []
    straight = run_single_training(_trainer(host, num_epochs=2, patience=5), str(tmp_path / "a"),
                                   log_fn=logs.append)
    run_single_training(_trainer(host, num_epochs=1, patience=5), str(tmp_path / "b"), log_fn=logs.append)
    resumed = run_single_training(_trainer(host, num_epochs=2, patience=5), str(tmp_path / "b"),
                                  log_fn=logs.append, resume=True)
    assert "Resumed run 0 from epoch 1" in logs and [r["epoch"] for r in resumed["history"]] == [2]
    for key in ("loss", "fsl_loss", "cpl_loss", "val_accuracy"):
        assert resumed["history"][0][key] == straight["history"][1][key], key
    a = torch.load(tmp_path / "a" / "resume_run0.ckpt", weights_only=True)
    b = torch.load(tmp_path / "b" / "resume_run0.ckpt", weights_only=True)
    torch.testing.assert_close(b["model"], a["model"], atol=0, rtol=0)


def test_wav_host_store_trains_evaluates_and_predicts():
    """A WavHostStore (float16) behind train, single and multi-segment
    test and ``predict_episode``, whose scores equal a PackedWavStore
    trainer's (it reads only the store's mean, std and seg_len)."""
    rng = np.random.default_rng(12)
    clips = [(0.3 * rng.standard_normal(int(rng.integers(8000, 40000)))).astype(np.float32) for _ in range(20)]
    labels = np.repeat(np.arange(5), 4)
    kw = dict(mean=-20.0, std=15.0, multi_segm=True, segment_seconds=1)
    host = WavHostStore.pack(clips, labels, dtype="float16", **kw)
    packed = PackedWavStore.pack(clips, labels, device="cpu", **kw)
    trainer = _trainer(host, geometry="wav", input_type="wav", multi_segm=True, waveaug_params={"use": False})
    assert trainer.host_mode and trainer.feat_shape == (128, 32)
    out = trainer.train_epoch()
    assert np.isfinite(out["loss"]) and 0.0 <= trainer.test()["mean_accuracy"] <= 1.0
    sup = np.stack([c[:16000] for c in clips[:6]])
    qry = np.stack([c[:16000] for c in clips[6:8]])
    sup_labels = np.repeat(np.arange(3), 2)
    other = _trainer(packed, geometry="wav", input_type="wav", multi_segm=True, waveaug_params={"use": False})
    other.model.load_state_dict(trainer.model.state_dict())
    np.testing.assert_array_equal(trainer.predict_episode(sup, sup_labels, qry)[1],
                                  other.predict_episode(sup, sup_labels, qry)[1])
