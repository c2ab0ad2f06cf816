"""PyTorch port: wav eval and predict with WaveAugment, and the model
variants (StandardCNN, the relation head, ``bn_per_view_group``), against
the JAX package on the CPU.

* One wav eval batch and ``predict_episode`` with WaveAugment: the JAX
  package's ``_make_wav_views_pair`` runs its chain from the key (support
  and queries through one chain call, and, for a model whose queries are not
  augmented, each group on its own), the port gets the draws recomputed from
  that key; then the same model on weights bridged by
  ``from_jax_variables``. Scores within 1e-3 [1.6e-4], argmax equal, on
  clips of a tone in noise.
* The variants in eval mode on the same views and weights: StandardCNN at
  F' x T' = 3 x 4 (where the flatten order matters), the relation head
  (K2 does not run), grouped BatchNorm (eval applies the running
  statistics, the head's through ``bn_grouped``): scores within 1e-3.
* ``grouped_batch_norm`` in train mode against the JAX package's
  ``BandwidthBatchNorm._grouped``: outputs 1e-5, running statistics 1e-6.
* The weight bridge for each variant, leaf by leaf.
* The engine on a WaveAugment model: the eval batch's reckoned bytes,
  multi-segment ``evaluate``, ``test()`` and the raw-audio ``cli.predict``.
"""

import dataclasses
import functools
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import (
    GEOMETRIES, exp_dict, jax_episode_chain_draws, jax_variables, numpy_draws, jax_views, port_model,
    split_chain, torch_chain,
)
from audio_few_shot_learning_tpu import config as jcfg
from audio_few_shot_learning_tpu.models.encoders import BandwidthBatchNorm as JaxBandwidthBatchNorm
from audio_few_shot_learning_tpu.ops.mel import MelSpec as JaxMelSpec
from audio_few_shot_learning_tpu.ops.waveaugment import WaveAugment as JaxWaveAugment
from audio_few_shot_learning_tpu.train.engine import Trainer as JaxTrainer
from audio_few_shot_learning_tpu_torch import config as tcfg
from audio_few_shot_learning_tpu_torch.data.episodes import sample_episode
from audio_few_shot_learning_tpu_torch.data.wavstore import PackedWavStore
from audio_few_shot_learning_tpu_torch.models.encoders import BandwidthBatchNorm, HeadBatchNorm
from audio_few_shot_learning_tpu_torch.ops import protohead
from audio_few_shot_learning_tpu_torch.ops.mel import MelSpec
from audio_few_shot_learning_tpu_torch.train import engine
from audio_few_shot_learning_tpu_torch.train.weights import from_jax_variables

SR = 16000
N_WAY, K_SHOT, K_QUERY = 3, 2, 2
SCORE_ATOL = 1e-3
WAVEAUG = {"use": True, "aug_num": 2}


def _wav_store(seed=3, n_classes=5, per_class=5):
    """1-s clips z-normed with their own log-mel statistics."""
    rng = np.random.default_rng(seed)
    t = np.arange(SR) / SR
    f0 = rng.uniform(200, 2000, (n_classes * per_class, 1))
    wavs = (0.4 * np.sin(2 * np.pi * f0 * t) + 0.2 * rng.standard_normal((len(f0), SR))).astype(np.float32)
    mel = MelSpec("online")(torch.from_numpy(wavs))
    return PackedWavStore.pack(list(wavs), np.repeat(np.arange(n_classes), per_class), mean=float(mel.mean()),
                               std=float(mel.std()), device="cpu")


@functools.lru_cache(maxsize=None)
def _wav_bridged(use_attention=True, test_query_augmentations=True, seed=31):
    d = exp_dict(use_attention=use_attention, input_type="wav", waveaug_params=WAVEAUG,
                 test_query_augmentations=test_query_augmentations)
    mdl = GEOMETRIES["wav"][1]
    if not use_attention:
        mdl = {**mdl, "Projection": {**mdl["Projection"], "input_dim": 32}}
    jexp, jmdl = jcfg.ExperimentConfig.from_dict(d), jcfg.ModelConfig.from_dict(mdl)
    texp, tmdl = tcfg.ExperimentConfig.from_dict(d), tcfg.ModelConfig.from_dict(mdl)
    jmodel, variables = jax_variables(jexp, jmdl, GEOMETRIES["wav"][0], seed=seed)
    store = _wav_store()
    trainer = engine.Trainer(texp, tmdl, store, test_store=store)
    trainer.model.load_state_dict(from_jax_variables(variables), strict=True)
    return jexp, jmodel, variables, trainer, store


def _jax_wav_scores(jexp, jmodel, variables, sup, qry, labels, key, aug_q, store):
    """The JAX package's wav eval chain: ``_make_wav_views_pair`` (its
    WaveAugment from ``split(key)``, engine.py:526-532), then the model."""
    fake = types.SimpleNamespace(
        exp=jexp, waveaug=True, mel=JaxMelSpec(flavor="online", use_pallas=False),
        waveaugment=JaxWaveAugment(jexp.waveaug_params, dataset_name=jexp.dataset_name))
    def fn(v, a, b, lab, k):
        k_s, k_q = jax.random.split(k)
        sv, qv = JaxTrainer._make_wav_views_pair(fake, a, b, k_s, k_q, aug_q, store)
        return jmodel.apply(v, sv, qv, lab, N_WAY, train=False).scores

    return np.asarray(jax.jit(fn)(variables, jnp.asarray(sup), jnp.asarray(qry), jnp.asarray(labels), key))


def _port_draws(jexp, key, e, s, q, aug_q, length):
    """The port's (support, queries) chain draws recomputed from the JAX key
    (the JAX chain runs inside ``jax.jit``): one chain over [S+Q] per
    episode when both groups are augmented, else the support's own from k_s
    (engine.py:216-241)."""
    raw, ds, n = jexp.waveaug_params.raw, jexp.dataset_name, jexp.waveaug_params.aug_num
    k_s, _ = jax.random.split(key)
    if aug_q:
        sup, qry = split_chain(jax_episode_chain_draws(raw, ds, k_s, e, n, s + q, length, jitted=True), s)
        return torch_chain(sup), torch_chain(qry)
    return torch_chain(jax_episode_chain_draws(raw, ds, k_s, e, n, s, length, jitted=True)), None


@pytest.mark.parametrize("use_attention,aug_q", [(True, True), (False, False)], ids=["joint", "separate"])
def test_waveaugment_eval_batch_matches_jax(use_attention, aug_q):
    jexp, jmodel, variables, trainer, store = _wav_bridged(use_attention, aug_q)
    e = 2
    ep = sample_episode(torch.Generator().manual_seed(4), store, N_WAY, K_SHOT, K_QUERY, e)
    key = jax.random.PRNGKey(5)
    draws = _port_draws(jexp, key, e, N_WAY * K_SHOT, N_WAY * K_QUERY, aug_q, store.seg_len)
    with torch.inference_mode():
        scores = trainer._episode_scores(ep, N_WAY, aug_q, trainer.gen, draws, store).numpy()
        acc = trainer._eval_episodes(ep, N_WAY, aug_q, draws, store).numpy()
    want = _jax_wav_scores(jexp, jmodel, variables, ep.support.numpy(), ep.query.numpy(),
                           ep.support_labels.numpy(), key, aug_q, store)
    rows = N_WAY * K_QUERY * (1 if use_attention or not aug_q else 1 + WAVEAUG["aug_num"])
    assert scores.shape == want.shape == (e, rows, N_WAY)
    np.testing.assert_allclose(scores, want, atol=SCORE_ATOL, rtol=0)
    np.testing.assert_array_equal(scores.argmax(-1), want.argmax(-1))
    np.testing.assert_allclose(acc, (want.argmax(-1) == ep.query_labels.numpy()).mean(-1), atol=1e-6)


def test_waveaugment_predict_episode_matches_jax():
    jexp, jmodel, variables, trainer, store = _wav_bridged(True, True)
    idx = np.arange(0, 25, 4)[: N_WAY * (K_SHOT + 1)]
    wavs = store.extract_segment(torch.from_numpy(idx), torch.zeros(len(idx), dtype=torch.long)).numpy()
    sup, qry = wavs[: N_WAY * K_SHOT], wavs[N_WAY * K_SHOT:]
    labels = np.repeat(np.arange(N_WAY), K_SHOT)
    key = jax.random.PRNGKey(0)  # the JAX package's default predict key
    draws = _port_draws(jexp, key, 1, len(sup), len(qry), True, store.seg_len)
    pred, scores = trainer.predict_episode(sup, labels, qry, draws=draws)
    want = _jax_wav_scores(jexp, jmodel, variables, sup[None], qry[None], labels[None], key, True, store)[0]
    assert scores.shape == (len(qry), N_WAY) and scores.dtype == np.float32
    np.testing.assert_allclose(scores, want, atol=SCORE_ATOL, rtol=0)
    np.testing.assert_array_equal(pred, want.argmax(-1))
    # its own draws: a generator seeded with 0 unless one is given
    again = trainer.predict_episode(sup, labels, qry)[1]
    np.testing.assert_array_equal(again, trainer.predict_episode(sup, labels, qry)[1])


CNN_MODEL = {**GEOMETRIES["fprime"][1], "CNN": {"pool_dim": [2, 2], "hidden_channels": 8, "out_dim": 32}}
VARIANTS = {  # name -> (config overrides, geometry, model dict)
    "cnn": ({"encoder_name": "CNN"}, "fprime", CNN_MODEL),
    "relation": ({"relation_head": True}, "small", GEOMETRIES["small"][1]),
    "bn_grouped": ({"tpu": {"compute_dtype": "float32", "bn_per_view_group": True}}, "small",
                   GEOMETRIES["small"][1]),
}


def _variant(name, seed=41):
    over, geometry, mdl = VARIANTS[name]
    d = exp_dict(**{k: v for k, v in over.items() if k != "tpu"})
    d["tpu"].update(over.get("tpu", {}))
    feat_shape = GEOMETRIES[geometry][0]
    jexp, jmdl = jcfg.ExperimentConfig.from_dict(d), jcfg.ModelConfig.from_dict(mdl)
    texp, tmdl = tcfg.ExperimentConfig.from_dict(d), tcfg.ModelConfig.from_dict(mdl)
    jmodel, variables = jax_variables(jexp, jmdl, feat_shape, seed=seed)
    return jexp, texp, tmdl, feat_shape, jmodel, variables


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_variant_eval_scores_match_jax(name, monkeypatch):
    jexp, texp, tmdl, (f, t), jmodel, variables = _variant(name)
    model = port_model(texp, tmdl, (f, t), variables)
    rng = np.random.default_rng(2)
    e, s, q = 2, N_WAY * K_SHOT, N_WAY * K_QUERY
    sup = rng.standard_normal((e, s, f, t)).astype(np.float32)
    qry = rng.standard_normal((e, q, f, t)).astype(np.float32)
    labels = np.tile(np.repeat(np.arange(N_WAY), K_SHOT), (e, 1))
    sv = jax_views(sup, numpy_draws(rng, e, s, f, t, 6))
    qv = jax_views(qry, numpy_draws(rng, e, q, f, t, 6))
    want = np.asarray(jax.jit(lambda v, a, b, lab: jmodel.apply(v, a, b, lab, N_WAY, train=False).scores)(
        variables, sv, qv, labels))
    launches = []
    monkeypatch.setattr(protohead, "batched_episode_scores_reference",
                        _counting(protohead.batched_episode_scores_reference, launches))
    with torch.inference_mode():
        got = model(torch.from_numpy(sv), torch.from_numpy(qv), torch.from_numpy(labels), N_WAY).scores.numpy()
    np.testing.assert_allclose(got, want, atol=SCORE_ATOL, rtol=0)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    assert len(launches) == (0 if name == "relation" else 1)  # the relation head replaces the K2 head


def _counting(fn, calls):
    def wrapped(*a, **k):
        calls.append(None)
        return fn(*a, **k)
    return wrapped


@pytest.mark.parametrize("which", ["conv", "head"])
def test_grouped_batch_norm_matches_jax(which):
    """Train mode with (S, Vs, Q, Vq) = (3, 2, 2, 1) over E = 2 episodes:
    each group normalizes with its own statistics; the running statistics
    move once, by the mean of the groups' (unbiased) statistics."""
    rng = np.random.default_rng(7)
    c, groups = 6, (3, 2, 2, 1)
    b = 2 * (3 * 2 + 2 * 1)
    shape = (b, c, 5, 4) if which == "conv" else (b, c)
    x = (1.0 + 2.0 * rng.standard_normal(shape)).astype(np.float32)
    scale, bias = rng.uniform(0.5, 1.5, c).astype(np.float32), rng.uniform(-0.1, 0.1, c).astype(np.float32)
    mean, var = (0.1 * rng.standard_normal(c)).astype(np.float32), rng.uniform(0.5, 2.0, c).astype(np.float32)
    variables = {"params": {"scale": scale, "bias": bias}, "batch_stats": {"mean": mean, "var": var}}
    xj = np.moveaxis(x, 1, -1) if which == "conv" else x
    out, upd = JaxBandwidthBatchNorm().apply(variables, xj, train=True, view_groups=groups, mutable=["batch_stats"])
    want = np.moveaxis(np.asarray(out), -1, 1) if which == "conv" else np.asarray(out)
    port = BandwidthBatchNorm(c) if which == "conv" else HeadBatchNorm(c)
    with torch.no_grad():
        for name, v in (("weight", scale), ("bias", bias), ("running_mean", mean), ("running_var", var)):
            getattr(port, name).copy_(torch.from_numpy(v))
    port.train()
    got = (port(torch.from_numpy(x), view_groups=groups) if which == "conv" else
           port(torch.from_numpy(x), groups)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(port.running_mean.numpy(), np.asarray(upd["batch_stats"]["mean"]), atol=1e-6)
    np.testing.assert_allclose(port.running_var.numpy(), np.asarray(upd["batch_stats"]["var"]), atol=1e-6)
    assert int(port.num_batches_tracked) == 1
    if which == "conv":  # a remat recompute normalizes alike and leaves the statistics alone
        before = port.running_mean.clone()
        again = port(torch.from_numpy(x), update_stats=False, view_groups=groups).detach().numpy()
        np.testing.assert_array_equal(again, got)
        assert torch.equal(port.running_mean, before) and int(port.num_batches_tracked) == 1


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_weight_bridge_maps_each_variant(name):
    """Leaf by leaf: the CNN head's Linear takes flax's (F', T', C) rows in
    the reference's (C, F', T') order (F' x T' = 12), the relation head maps
    to ``relation_head.{fc1,fc2,fc3,out}`` (matrices transposed), and a
    grouped model's head statistics come from ``bn_grouped``."""
    jexp, texp, tmdl, feat_shape, _, variables = _variant(name)
    sd = from_jax_variables(variables)
    port_model(texp, tmdl, feat_shape, variables)  # strict load
    params, stats = variables["params"], variables["batch_stats"]
    head = params["backbone"]["_LogitsHead_0"]
    if name == "cnn":
        kernel = head["Dense_0"]["kernel"]  # [(F', T', C), out]
        fp, tp, c = 3, 4, 8
        want = kernel.reshape(fp, tp, c, -1).transpose(3, 2, 0, 1).reshape(-1, fp * tp * c)
        np.testing.assert_array_equal(sd["backbone.encoder.logits.2.weight"].numpy(), want)
        scale = head["BatchNorm_0"]["scale"].reshape(fp, tp, c).transpose(2, 0, 1).ravel()
        np.testing.assert_array_equal(sd["backbone.encoder.logits.1.weight"].numpy(), scale)
    elif name == "relation":
        for fc in ("fc1", "fc2", "fc3", "out"):
            np.testing.assert_array_equal(sd[f"relation_head.{fc}.weight"].numpy(), params["relation"][fc]["kernel"].T)
            np.testing.assert_array_equal(sd[f"relation_head.{fc}.bias"].numpy(), params["relation"][fc]["bias"])
        assert sd["relation_head.fc1.weight"].shape == (256, 2 * 4 * 64)
    else:
        grouped = stats["backbone"]["_LogitsHead_0"]["bn_grouped"]
        np.testing.assert_array_equal(sd["backbone.encoder.logits.1.running_var"].numpy(), grouped["var"])
        np.testing.assert_array_equal(sd["backbone.encoder.logits.1.weight"].numpy(), head["bn_grouped"]["scale"])


def test_eval_batch_reckons_the_chain():
    """With WaveAugment an eval episode reckons 1 + aug_num views per item
    for block 0 plus the chain's bytes per augmented row; without it, none."""
    _, _, trainer, store = _wav_bridged(True, True)[1:]
    chain_row = trainer.waveaugment.row_bytes(store.seg_len)
    assert chain_row > 8 * store.seg_len
    block0 = engine.eval_episode_bytes(6, 6, 3, 3, trainer.model.backbone.encoder.eval_item_bytes)
    assert block0 == 12 * 3 * 16 * 128 * 32 * 4
    assert engine.eval_episode_bytes(6, 6, 3, 3, 16 * 128 * 32 * 4, 24, chain_row) == block0 + 24 * chain_row


def test_waveaugment_engine_paths_run(tmp_path):
    """Multi-segment ``evaluate``, ``test()`` and the raw-audio CLI on a
    WaveAugment model, on the CPU."""
    from audio_few_shot_learning_tpu_torch.cli import predict

    _, _, variables, trainer, _ = _wav_bridged(True, True)
    rng = np.random.default_rng(8)
    clips = [(0.3 * rng.standard_normal(n)).astype(np.float32) for n in rng.integers(SR // 2, 3 * SR, 20)]
    ms = PackedWavStore.pack(clips, np.repeat(np.arange(4), 5), mean=trainer.train_store.mean,
                             std=trainer.train_store.std, multi_segm=True, segment_seconds=1, device="cpu")
    mean, std = trainer.evaluate(ms, 2, N_WAY, K_SHOT, K_QUERY, True, multisegment=True)
    assert 0.0 <= mean <= 1.0 and std >= 0.0 and ms.s_max == 3
    trainer.exp = dataclasses.replace(trainer.exp, n_testing_tasks=2)
    assert 0.0 <= trainer.test()["mean_accuracy"] <= 1.0

    import scipy.io.wavfile

    for c in range(N_WAY):
        (tmp_path / "support" / f"c{c}").mkdir(parents=True)
        for i in range(K_SHOT):
            scipy.io.wavfile.write(tmp_path / "support" / f"c{c}" / f"{i}.wav", SR, clips[5 * c + i][:SR])
    (tmp_path / "q").mkdir()
    np.save(tmp_path / "q" / "a.npy", clips[3][:SR])
    torch.save(from_jax_variables(variables), tmp_path / "model.pt")
    d = exp_dict(input_type="wav", waveaug_params=WAVEAUG)
    (tmp_path / "exp.json").write_text(json.dumps(d))
    (tmp_path / "mdl.json").write_text(json.dumps(GEOMETRIES["wav"][1]))
    predict.main(["-e", str(tmp_path / "exp.json"), "-m", str(tmp_path / "mdl.json"),
                  "--checkpoint", str(tmp_path / "model.pt"), "--support", str(tmp_path / "support"),
                  "--query", str(tmp_path / "q"), "--output", str(tmp_path / "out.json")])
    out = json.loads((tmp_path / "out.json").read_text())
    assert out["classes"] == ["c0", "c1", "c2"] and out["predictions"][0]["predicted_class"] in out["classes"]
