"""PyTorch port: the wav serving slice on the CPU, against the JAX package.

* ``PackedWavStore``: packing and ``extract_segment`` equal the JAX store's
  to the bit for long, exact-multiple, short and empty items.
* ``sample_episode`` on a wav store: shapes, labels and class, item and segment
  frequencies by chi-square (JAX keys and torch generators never agree, so
  samplers are compared by distribution, as test_torch_port_sampler.py does).
* One wav eval batch and ``predict_episode`` on waveforms: the port's
  online log-mel -> z-norm -> model against the JAX package's, on weights
  bridged by ``from_jax_variables``; scores within 1e-3, argmax equal.
* ``cli.predict`` end to end for a wav-input model and for a spec model fed
  ``.wav`` files (offline log-mel), scores against the JAX pipeline on the
  same files.
* A WaveAugment Trainer builds and predicts; no card raises; a
  multi-segment test episode's layout.

1-s clips (L = 16 000, 128x32 features) and the "wav" test geometry keep it small.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io.wavfile
import scipy.stats
import torch

from _torch_port_helpers import GEOMETRIES, exp_dict, jax_variables
from audio_few_shot_learning_tpu import config as jcfg
from audio_few_shot_learning_tpu.data.wavstore import PackedWavStore as JaxWavStore
from audio_few_shot_learning_tpu.ops.mel import MelSpec as JaxMelSpec
from audio_few_shot_learning_tpu.preprocessing.audio_io import load_audio as jax_load_audio
from audio_few_shot_learning_tpu_torch import config as tcfg
from audio_few_shot_learning_tpu_torch.data.episodes import sample_episode
from audio_few_shot_learning_tpu_torch.data.wavstore import PackedWavStore
from audio_few_shot_learning_tpu_torch.train.engine import Trainer
from audio_few_shot_learning_tpu_torch.train.weights import from_jax_variables

SR = 16000
SCORE_ATOL = 1e-3
N_WAY, K_SHOT, K_QUERY = 3, 2, 2
MEAN, STD = -20.0, 15.0  # the store's global log-mel statistics


def _clip(rng, length=SR):
    return (0.3 * rng.standard_normal(length)).astype(np.float32)


# ---------------------------------------------------------------------------
# store
# ---------------------------------------------------------------------------


def _ragged_items(rng):
    """short (< 1 s), exact 2 s, 1 s + tail, empty, 3.5 s."""
    return [_clip(rng, n) for n in (600, 2 * SR, SR + 500, 0, 3 * SR + SR // 2)]


@pytest.mark.parametrize("multi_segm", [True, False])
def test_pack_matches_jax_store(multi_segm):
    items = _ragged_items(np.random.default_rng(0))
    labels = [0, 1, 2, 0, 1]
    kw = dict(n_classes=3, mean=MEAN, std=STD, multi_segm=multi_segm, segment_seconds=1)
    want = JaxWavStore.pack(items, labels, **kw)
    got = PackedWavStore.pack(items, labels, device="cpu", **kw)
    np.testing.assert_array_equal(got.waveforms.numpy(), np.asarray(want.waveforms))
    np.testing.assert_array_equal(got.tails.numpy(), np.asarray(want.tails))
    for name in ("offsets", "tail_index", "lengths", "seg_counts", "labels", "class_table", "class_counts"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)), name)
    assert (got.n_classes, got.s_max, got.multi_segm, got.seg_len) == (
        want.n_classes, want.s_max, want.multi_segm, want.seg_len)
    assert (got.mean, got.std) == (float(want.mean), float(want.std))
    assert got.feat_shape == want.feat_shape and got.nbytes() == want.nbytes()


@pytest.mark.parametrize("multi_segm", [True, False])
def test_extract_segment_matches_jax(multi_segm):
    items = _ragged_items(np.random.default_rng(1))
    kw = dict(n_classes=2, multi_segm=multi_segm, segment_seconds=1)
    want = JaxWavStore.pack(items, [0, 1, 0, 1, 0], **kw)
    got = PackedWavStore.pack(items, [0, 1, 0, 1, 0], device="cpu", **kw)
    counts = np.asarray(want.seg_counts)
    pairs = [(i, s) for i in range(len(items)) for s in range(counts[i])]
    item, seg = (np.array(v) for v in zip(*pairs))
    expect = np.asarray(jax.vmap(want.extract_segment)(jnp.asarray(item), jnp.asarray(seg)))
    out = got.extract_segment(torch.from_numpy(item).reshape(-1, 1), torch.from_numpy(seg).reshape(-1, 1))
    assert out.shape == (len(pairs), 1, got.seg_len)
    np.testing.assert_array_equal(out[:, 0].numpy(), expect)
    if multi_segm:  # the reference's semantics, spelled out
        short, exact, tail = items[0], items[1], items[2]
        np.testing.assert_array_equal(expect[0], np.tile(short, 27)[:SR])
        np.testing.assert_array_equal(expect[1:3], exact.reshape(2, SR))
        np.testing.assert_array_equal(expect[4], np.tile(tail, 2)[:SR])
        np.testing.assert_array_equal(expect[5], np.zeros(SR, np.float32))  # empty item


def test_single_segment_store_returns_whole_equal_length_clips():
    rng = np.random.default_rng(2)
    wavs = [_clip(rng) for _ in range(6)]
    store = PackedWavStore.pack(wavs, [0, 0, 1, 1, 2, 2], device="cpu")
    assert store.seg_len == SR and store.tails.shape == (1, SR)
    out = store.extract_segment(torch.arange(6), torch.zeros(6, dtype=torch.long))
    np.testing.assert_array_equal(out.numpy(), np.stack(wavs))


# ---------------------------------------------------------------------------
# sampler
# ---------------------------------------------------------------------------

N_CLASSES, PER_CLASS = 8, 6


def _id_wav_store(multi_segm=False):
    """Item i's samples are all i (segment s of a multi-segment item i is
    10*i + s), so a sampled row names its item and segment."""
    labels = np.repeat(np.arange(N_CLASSES), PER_CLASS)
    if multi_segm:
        items = [np.repeat(10.0 * i + np.arange(3), 4).astype(np.float32) for i in range(len(labels))]
        return PackedWavStore.pack(items, labels, multi_segm=True, segment_seconds=1, sr=4,
                                   device="cpu"), labels
    items = [np.full(5, i, np.float32) for i in range(len(labels))]
    return PackedWavStore.pack(items, labels, device="cpu"), labels


def test_wav_episode_shapes_labels_and_sorted_classes():
    store, labels = _id_wav_store()
    e = 64
    ep = sample_episode(torch.Generator().manual_seed(0), store, N_WAY, K_SHOT, K_QUERY, batch=e)
    assert ep.support.shape == (e, N_WAY * K_SHOT, 5) and ep.query.shape == (e, N_WAY * K_QUERY, 5)
    np.testing.assert_array_equal(ep.support_labels[0].numpy(), [0, 0, 1, 1, 2, 2])
    np.testing.assert_array_equal(ep.query_labels[0].numpy(), [0, 0, 1, 1, 2, 2])
    sup, qry = ep.support[..., 0].long().numpy(), ep.query[..., 0].long().numpy()
    for i in range(e):
        sup_cls = labels[sup[i]].reshape(N_WAY, K_SHOT)
        qry_cls = labels[qry[i]].reshape(N_WAY, K_QUERY)
        assert (sup_cls == sup_cls[:, :1]).all() and (qry_cls == sup_cls[:, :1]).all()
        assert (np.diff(sup_cls[:, 0]) > 0).all()
        both = np.concatenate([sup[i], qry[i]])
        assert len(set(both.tolist())) == len(both)


def test_wav_episode_class_and_item_frequencies_uniform():
    store, labels = _id_wav_store()
    ep = sample_episode(torch.Generator().manual_seed(1), store, 2, 1, 1, batch=1200)
    items = ep.support[..., 0].long().numpy().ravel()
    classes = np.bincount(labels[items], minlength=N_CLASSES)
    assert scipy.stats.chisquare(classes).pvalue > 1e-4, classes
    per_item = np.bincount(items, minlength=N_CLASSES * PER_CLASS)
    assert scipy.stats.chisquare(per_item).pvalue > 1e-4, per_item


def test_wav_episode_segment_pick_uniform_and_multi_segment_test_layout():
    store, _ = _id_wav_store(multi_segm=True)
    assert store.s_max == 3 and store.seg_len == 4
    ep = sample_episode(torch.Generator().manual_seed(2), store, 4, 2, 2, batch=300)
    first = ep.support[..., 0].numpy()
    np.testing.assert_array_equal(ep.support.numpy(), np.repeat(first[..., None], 4, -1))
    seg = (first.round().astype(int) % 10).ravel()
    assert scipy.stats.chisquare(np.bincount(seg, minlength=3)).pvalue > 1e-4
    # a test episode: every segment of each query item, query-major, all real here
    test = sample_episode(torch.Generator(), store, 4, 2, 2, is_test=True)
    assert test.query.shape == (1, 4 * 2 * 3, 4) and test.support.shape == (1, 8, 4)
    rows = test.query[0, :, 0].numpy().reshape(8, 3)
    np.testing.assert_array_equal(rows % 10, np.tile(np.arange(3), (8, 1)))
    np.testing.assert_array_equal(rows // 10, np.repeat(rows[:, :1] // 10, 3, 1))
    np.testing.assert_array_equal(test.query_mask.numpy(), np.ones((1, 24), np.float32))
    np.testing.assert_array_equal(test.audio_ids[0].numpy(), np.repeat(np.arange(8), 3))
    np.testing.assert_array_equal(test.query_labels[0].numpy(), np.repeat(np.arange(4), 6))


# ---------------------------------------------------------------------------
# eval batch and predict_episode against the JAX pipeline
# ---------------------------------------------------------------------------


def _wav_configs(**over):
    e = exp_dict(input_type="wav", waveaug_params={"use": False}, **over)
    mdl = GEOMETRIES["wav"][1]
    return (jcfg.ExperimentConfig.from_dict(e), jcfg.ModelConfig.from_dict(mdl),
            tcfg.ExperimentConfig.from_dict(e), tcfg.ModelConfig.from_dict(mdl), e, mdl)


@pytest.fixture(scope="module")
def wav_bridged():
    """JAX model + variables and a CPU port wav Trainer on the same weights."""
    jexp, jmdl, texp, tmdl, _, _ = _wav_configs()
    jmodel, variables = jax_variables(jexp, jmdl, GEOMETRIES["wav"][0], seed=31)
    rng = np.random.default_rng(3)
    store = PackedWavStore.pack([_clip(rng) for _ in range(5 * 5)], np.repeat(np.arange(5), 5),
                                mean=MEAN, std=STD, device="cpu")
    trainer = Trainer(texp, tmdl, store, test_store=store)  # config says "device": "cpu"
    trainer.model.load_state_dict(from_jax_variables(variables), strict=True)
    return jmodel, variables, trainer, store


def _jax_wav_scores(jmodel, variables, sup, qry, labels, mean=MEAN, std=STD):
    """The JAX package's wav eval chain (engine.py:196-253 with WaveAugment
    off): one online log-mel over support and queries, z-norm, model."""
    e, s, length = sup.shape
    flat = np.concatenate([sup, qry], axis=1).reshape(-1, length)
    mels = (JaxMelSpec(flavor="online", use_pallas=False)(jnp.asarray(flat)) - mean) / std
    mels = mels.reshape(e, -1, 1, *mels.shape[-2:])
    fn = jax.jit(lambda v, a, b, lab: jmodel.apply(v, a, b, lab, N_WAY, train=False).scores)
    return np.asarray(fn(variables, mels[:, :s], mels[:, s:], jnp.asarray(labels)))


def test_wav_eval_batch_matches_jax(wav_bridged):
    jmodel, variables, trainer, store = wav_bridged
    ep = sample_episode(torch.Generator().manual_seed(4), store, N_WAY, K_SHOT, K_QUERY, batch=2)
    with torch.inference_mode():
        scores = trainer._episode_scores(ep, N_WAY, True, trainer.gen, store=store).numpy()
        acc = trainer._eval_episodes(ep, N_WAY, True, store=store).numpy()
    want = _jax_wav_scores(jmodel, variables, ep.support.numpy(), ep.query.numpy(),
                           ep.support_labels.numpy())
    assert scores.shape == (2, N_WAY * K_QUERY, N_WAY)
    np.testing.assert_allclose(scores, want, atol=SCORE_ATOL, rtol=0)
    np.testing.assert_array_equal(scores.argmax(-1), want.argmax(-1))
    np.testing.assert_allclose(acc, (want.argmax(-1) == ep.query_labels.numpy()).mean(-1), atol=1e-6)


def test_wav_predict_episode_matches_jax(wav_bridged):
    jmodel, variables, trainer, _ = wav_bridged
    rng = np.random.default_rng(5)
    sup = np.stack([_clip(rng) for _ in range(N_WAY * K_SHOT)])
    qry = np.stack([_clip(rng) for _ in range(N_WAY * K_QUERY)])
    labels = np.repeat(np.arange(N_WAY), K_SHOT)
    pred, scores = trainer.predict_episode(sup, labels, qry)
    want = _jax_wav_scores(jmodel, variables, sup[None], qry[None], labels[None])[0]
    assert scores.shape == (N_WAY * K_QUERY, N_WAY) and scores.dtype == np.float32
    np.testing.assert_allclose(scores, want, atol=SCORE_ATOL, rtol=0)
    np.testing.assert_array_equal(pred, want.argmax(-1))


def test_wav_test_run_reports_accuracy(wav_bridged, monkeypatch):
    _, _, trainer, _ = wav_bridged
    monkeypatch.setattr(trainer, "exp", dataclasses.replace(trainer.exp, n_testing_tasks=3))
    result = trainer.test()
    assert 0.0 <= result["mean_accuracy"] <= 1.0 and result["accuracy_std"] >= 0.0


# ---------------------------------------------------------------------------
# cli.predict end to end
# ---------------------------------------------------------------------------


def _write_episode(tmp_path, rng, ragged):
    """3 classes x 2 support clips and 3 queries: .wav files in int16 and
    float32 encodings and one 1-D .npy. ``ragged``: clips of several lengths
    (a wav model conforms them; a spec model needs one feature shape)."""
    for c, name in enumerate(("bird", "dog", "rain")):
        (tmp_path / "support" / name).mkdir(parents=True)
        for i, length in enumerate((SR, SR - 3000 * c * ragged)):
            x = _clip(rng, length)
            data = (x * 32767).astype(np.int16) if i == 0 else x
            scipy.io.wavfile.write(tmp_path / "support" / name / f"{i}.wav", SR, data)
    (tmp_path / "q").mkdir()
    scipy.io.wavfile.write(tmp_path / "q" / "a.wav", SR, _clip(rng, SR + 700 * ragged))
    scipy.io.wavfile.write(tmp_path / "q" / "b.wav", SR, (_clip(rng, SR - 100 * ragged) * 32767).astype(np.int16))
    np.save(tmp_path / "q" / "c.npy", _clip(rng, SR))
    np.save(tmp_path / "stats.npy", np.array([MEAN, STD], np.float32).reshape(2, 1, 1))


def _episode_files(tmp_path):
    sup = sorted((tmp_path / "support").glob("*/*"))
    return sup, [sup_f.parent.name for sup_f in sup], sorted((tmp_path / "q").iterdir())


def _load(path):
    return np.load(path).astype(np.float32) if path.suffix == ".npy" else jax_load_audio(path, sr=SR)


@pytest.mark.parametrize("input_type", ["wav", "spec"])
def test_predict_cli_raw_audio_matches_jax(tmp_path, input_type):
    """Raw audio through the CLI: for a wav model the waveforms, conformed
    to the longest support clip; for a spec model (SpecAugment off, so the
    scores are deterministic) offline log-mel features. Scores against the
    JAX package's pipeline on the same files."""
    from audio_few_shot_learning_tpu_torch.cli import predict

    _write_episode(tmp_path, np.random.default_rng(6), ragged=input_type == "wav")
    e = exp_dict(input_type=input_type, waveaug_params={"use": False}, specaug_params={"use": False})
    jexp = jcfg.ExperimentConfig.from_dict(e)
    jmodel, variables = jax_variables(jexp, jcfg.ModelConfig.from_dict(GEOMETRIES["wav"][1]),
                                      GEOMETRIES["wav"][0], seed=41)
    torch.save(from_jax_variables(variables), tmp_path / "model.pt")
    (tmp_path / "exp.json").write_text(json.dumps(e))
    (tmp_path / "mdl.json").write_text(json.dumps(GEOMETRIES["wav"][1]))
    args = ["-e", str(tmp_path / "exp.json"), "-m", str(tmp_path / "mdl.json"),
            "--checkpoint", str(tmp_path / "model.pt"), "--support", str(tmp_path / "support"),
            "--query", str(tmp_path / "q"), "--norm-stats", str(tmp_path / "stats.npy"),
            "--output", str(tmp_path / "out.json")]
    predict.main(args)
    out = json.loads((tmp_path / "out.json").read_text())
    assert out["classes"] == ["bird", "dog", "rain"] and len(out["predictions"]) == 3

    sup_files, sup_names, qry_files = _episode_files(tmp_path)
    labels = np.array([out["classes"].index(n) for n in sup_names])
    sup_w, qry_w = [_load(f) for f in sup_files], [_load(f) for f in qry_files]
    if input_type == "wav":  # conform to the longest support clip (JAX cli/predict.py:161-166)
        length = max(len(x) for x in sup_w)
        sup, qry = (np.stack([np.pad(x[:length], (0, max(0, length - len(x)))) for x in xs])
                    for xs in (sup_w, qry_w))
        want = _jax_wav_scores(jmodel, variables, sup[None], qry[None], labels[None])[0]
    else:  # offline flavour, z-norm, one view (JAX cli/predict.py:78-91)
        mel = JaxMelSpec(flavor="offline", use_pallas=False)
        feats = [(np.asarray(mel(jnp.asarray(x))) - MEAN) / STD for x in sup_w + qry_w]
        views = np.stack(feats)[None, :, None]
        s = len(sup_w)
        fn = jax.jit(lambda v, a, b, lab: jmodel.apply(v, a, b, lab, N_WAY, train=False).scores)
        want = np.asarray(fn(variables, views[:, :s], views[:, s:], labels[None]))[0]
    for p, f, w in zip(out["predictions"], qry_files, want):
        assert p["file"] == str(f)
        got = np.array([p["scores"][c] for c in out["classes"]])
        np.testing.assert_allclose(got, w, atol=SCORE_ATOL, rtol=0)  # the JSON rounds to 1e-4
        assert p["predicted_class"] == out["classes"][int(w.argmax())]

    if input_type == "spec":
        with pytest.raises(SystemExit, match="norm-stats"):
            predict.main(args[: args.index("--norm-stats")] + args[args.index("--output"):])


# ---------------------------------------------------------------------------
# what raises
# ---------------------------------------------------------------------------


def test_wav_trainer_raises_for_waveaugment_and_no_card(wav_bridged, monkeypatch):
    """WaveAugment, once refused, builds a Trainer of 1 + aug_num views that
    predicts; without a card and unasked for the CPU the engine raises."""
    *_, store = wav_bridged
    _, _, texp, tmdl, _, _ = _wav_configs()
    waveaug = dataclasses.replace(texp, waveaug_params=tcfg.WaveAugParams(use=True, aug_num=2))
    aug_trainer = Trainer(waveaug, tmdl, store)
    assert aug_trainer.v_support == aug_trainer._v_query(True) == 3
    wavs = store.extract_segment(torch.arange(9), torch.zeros(9, dtype=torch.long)).numpy()
    pred, scores = aug_trainer.predict_episode(wavs[:6], np.repeat(np.arange(N_WAY), 2), wavs[6:])
    assert scores.shape == (3, N_WAY) and np.isfinite(scores).all()

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    gpu_exp = dataclasses.replace(texp, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(gpu_exp, tmdl, store)
    assert Trainer(gpu_exp, tmdl, store, device="cpu").mel.flavor == "online"
