"""PyTorch port: the training path against the JAX package, on the CPU.

One train step of the port's ``Trainer`` against ``jax.value_and_grad`` of
the JAX package's ``Trainer._loss_and_metrics`` plus its optax Adam update,
on the same weights, episodes, views and view permutations, with every
dropout the identity on both sides (``p = 0`` on the port's modules,
``flax.linen.Dropout`` patched to the identity inside the test) and CPL at
M = class size, where its sampling takes every member. The configurations:
the flagship (CPL, attention, SpecAugment; also with
``episode_microbatch``), wav input with WaveAugment (the JAX side runs its
real chain from the key, the port gets the draws recomputed from it), the
plain configs' structure (no attention, one view, no contrastive branch),
APL with prototypes and with class members as anchors, the StandardCNN
encoder at F' * T' = 12, the relation head, and ``bn_per_view_group``. The
BatchNorm train path against the JAX modules; remat against no remat;
resume against a run straight through; the ``train_test`` CLI end to end.

Tolerances (float32 on both sides, another summation order in every conv,
matmul and reduction; observed worst cases in brackets): loss 1e-4 relative
[2e-6]; each gradient within 1e-4 of that tensor's largest |g| [4.3e-5],
except the conv biases ahead of a train-mode BatchNorm, which removes their
mean: their gradient is zero but for rounding, so on both sides it stays
under 1e-2 of the largest |g| of the same conv's weight [5e-6]. Each
parameter after the Adam step within 1e-3 x lr [3.8e-4 x lr] where the
gradient's sign is sure (|g| above the allowed gradient difference);
elsewhere, and on those biases, Adam's first step ~lr * sign(g) may flip, so
those entries are held to twice the step bound, 2 x lr.
Running statistics 1e-6 [7.5e-7].
"""

import dataclasses
import functools
import json
import types

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_port_helpers import (  # noqa: F401  (jax_native_packer: a fixture)
    GEOMETRIES, configs, exp_dict, jax_episode_chain_draws, jax_native_packer, jax_variables, jax_views,
    numpy_draws, split_chain, torch_chain, torch_draws,
)
from audio_few_shot_learning_tpu import config as jcfg
from audio_few_shot_learning_tpu.data.episodes import EpisodeBatch as JaxEpisodeBatch
from audio_few_shot_learning_tpu.models.encoders import BandwidthBatchNorm as JaxBandwidthBatchNorm
from audio_few_shot_learning_tpu.ops.mel import MelSpec as JaxMelSpec
from audio_few_shot_learning_tpu.ops.waveaugment import WaveAugment as JaxWaveAugment
from audio_few_shot_learning_tpu.train.engine import Trainer as JaxTrainer
from audio_few_shot_learning_tpu.train.state import make_optimizer as jax_make_optimizer
from audio_few_shot_learning_tpu_torch import config as tcfg
from audio_few_shot_learning_tpu_torch.data.episodes import sample_episode
from audio_few_shot_learning_tpu_torch.data.hoststore import HostStore
from audio_few_shot_learning_tpu_torch.data.store import PackedStore
from audio_few_shot_learning_tpu_torch.data.wavstore import PackedWavStore
from audio_few_shot_learning_tpu_torch.models.dropout import Dropout
from audio_few_shot_learning_tpu_torch.models.encoders import BandwidthBatchNorm, HeadBatchNorm
from audio_few_shot_learning_tpu_torch.train.engine import Trainer, TrainDraws
from audio_few_shot_learning_tpu_torch.train.weights import from_jax_variables

N_WAY, K_SHOT, K_QUERY, E, V = 3, 2, 2, 2, 4
LR = 1e-3
LOSS_RTOL, GRAD_REL, BN_BIAS_NOISE, STATS_ATOL = 1e-4, 1e-4, 1e-2, 1e-6
PARAM_ATOL = 1e-3 * LR


def _step_dict(**tpu):
    d = exp_dict(
        n_way_train=N_WAY, n_shot_train=K_SHOT, n_query_train=K_QUERY,
        n_way_validation=N_WAY, n_shot_validation=K_SHOT, n_query_validation=K_QUERY,
        n_training_tasks=E, lr=LR, scheduler_milestones=[1], scheduler_gamma=0.5,
        loss={"l_param": 1.5, "cpl": {"use": True, "m_param": K_QUERY, "t_param": 2.0}},
    )
    d["tpu"].update({"episode_batch": E, **tpu})
    return d


WAVEAUG = {"use": True, "aug_num": V - 1}
CNN_MODEL = {**GEOMETRIES["fprime"][1], "CNN": {"pool_dim": [2, 2], "hidden_channels": 8, "out_dim": 32}}
# name -> (tpu overrides, episodes per chunk, config overrides, geometry, model dict or None)
STEP_CASES = {
    "tpu0-2": ({}, E, {}, "small", None),  # the flagship (ids kept from the earlier parametrisation)
    "tpu1-1": ({"episode_microbatch": 1}, 1, {}, "small", None),
    "wav_waveaug": ({}, E, {"input_type": "wav", "waveaug_params": WAVEAUG}, "wav", None),
    "plain": ({}, E, {"use_attention": False, "use_contrastive": False, "specaug_params": {"use": False},
                      "train_query_augmentations": False, "loss": {"l_param": 0.0, "cpl": {"use": False}}},
              "small", None),
    "apl_anchors": ({}, E, {"loss": {"l_param": 1.7, "cpl": {"use": False}, "angular": {
        "use": True, "angle": 15.0, "prototypes_as_anchors": True}}}, "small", None),
    "apl_members": ({}, E, {"loss": {"l_param": 1.7, "cpl": {"use": False}, "angular": {
        "use": True, "angle": 15.0, "prototypes_as_anchors": False}}}, "small", None),
    "cnn": ({}, E, {"encoder_name": "CNN"}, "fprime", CNN_MODEL),
    "relation": ({}, E, {"relation_head": True}, "small", None),
    "bn_grouped": ({"bn_per_view_group": True}, E, {}, "small", None),
}
# Cases whose float32 step is further from float64 than the flagship's, held
# to (gradient share of the largest |g|, running-statistics atol):
# * plain: the JAX package's float32 step is up to 1.2e-4 of the largest |g|
#   off a float64 step of the same model (the port's: 4e-6), and its one-pass
#   BatchNorm variance moves the running variance by up to 1.6e-6;
# * wav with WaveAugment: the filters leave exact stop bands, and there the
#   power sits at float32 FFT rounding noise beside the log's eps, so the
#   two packages' log-mel of an augmented view differs by up to 9.5e-3 of
#   the z-norm's unit (0.045 dB) where the waveforms agree within 1.5e-6 of
#   their RMS; the conv stack's weight gradients then differ by up to
#   5.7e-2 of the largest |g| (the port's own float32 step is 1.3e-2 off
#   its float64 step), every other gradient by 5e-4. The loss holds at 1e-4.
STEP_TOL = {"plain": (2e-4, 5e-6), "wav_waveaug": (1e-1, 1e-4)}


def _store(feat_shape, n_classes=5, per_class=5, seed=0):
    rng = np.random.default_rng(seed)
    items = [rng.standard_normal(feat_shape).astype(np.float32) for _ in range(n_classes * per_class)]
    return PackedStore.pack(items, np.repeat(np.arange(n_classes), per_class), device="cpu")


def _no_dropout(model):
    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0


def _jax_perms(key, e, v):
    """The view permutations the JAX package's loss draws from ``key``."""
    k_perm = jax.random.split(key, 5)[3]
    return np.asarray(jax.vmap(lambda k: jax.random.permutation(k, jnp.arange(1, v)))(
        jax.random.split(k_perm, e)))


def _jax_step(jexp, jmdl, variables, ep, views_of, chunk, seed, store=None):
    """The JAX package's train step on numpy data: per chunk of ``chunk``
    episodes, value_and_grad of ``Trainer._loss_and_metrics`` with the spec
    views given as data (``views_of(specs, slice)``) or, for wav input, its
    own WaveAugment chain and log-mel (``store`` holds the z-norm), the
    BatchNorm statistics carried from chunk to chunk, the gradients and
    metrics averaged over chunks (engine.py:359-383), then the optax Adam
    update. Returns (loss, grads, new variables, perms, the chunk keys)."""
    from audio_few_shot_learning_tpu.models.protonets import FewShotEpisodeModel

    model = FewShotEpisodeModel(exp=jexp, mdl=jmdl)
    params, stats = variables["params"], variables["batch_stats"]
    is_wav = jexp.input_type == "wav"
    if is_wav:
        vq = 1 + jexp.waveaug_params.aug_num
    else:
        vq = 4 if jexp.specaug_params.use and jexp.train_query_augmentations else 1
    chunks = E // chunk
    grads, losses, perms, keys = [], [], [], []
    for c in range(chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        sup, qry = ep["support"][sl], ep["query"][sl]
        fake = types.SimpleNamespace(exp=jexp, is_wav=is_wav, model=model,
                                     specaug=not is_wav and jexp.specaug_params.use)
        if is_wav:
            fake.waveaug = True
            fake.waveaugment = JaxWaveAugment(jexp.waveaug_params, dataset_name=jexp.dataset_name)
            fake.mel = JaxMelSpec(flavor="online", use_pallas=False)
            fake._make_wav_views_pair = functools.partial(JaxTrainer._make_wav_views_pair, fake)
        else:
            views = [views_of(sup, sl, "support"), views_of(qry, sl, "query")]
            fake._make_views = lambda specs, key, enabled: jnp.asarray(views.pop(0))
        jep = JaxEpisodeBatch(
            support=jnp.asarray(sup), support_labels=jnp.asarray(ep["support_labels"][sl]),
            query=jnp.asarray(qry), query_labels=jnp.asarray(ep["query_labels"][sl]),
            audio_ids=jnp.zeros(qry.shape[:2], jnp.int32), query_mask=jnp.ones(qry.shape[:2]),
        )
        key = jax.random.PRNGKey(seed + c)
        keys.append(key)
        if vq > 1:
            perms.append(_jax_perms(key, chunk, vq))
        (_, (metrics, stats)), g = jax.jit(jax.value_and_grad(
            lambda p, st: JaxTrainer._loss_and_metrics(fake, p, st, jep, key, N_WAY, vq, store), has_aux=True
        ))(params, stats)
        grads.append(g)
        losses.append(float(metrics["loss"]))
    opt = jax_make_optimizer(LR, jexp.scheduler_milestones, jexp.scheduler_gamma, 1)

    @jax.jit  # one compile for the average and the update, not one per leaf shape
    def average_and_update(grads, params):
        mean = jax.tree.map(lambda *gs: functools.reduce(jnp.add, gs) / chunks, *grads)
        upd, _ = opt.update(mean, opt.init(params), params)
        return mean, optax.apply_updates(params, upd)

    grads, new_params = average_and_update(grads, params)
    new = {"params": new_params, "batch_stats": stats}
    tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return np.mean(losses), tree(grads), tree(new), (np.concatenate(perms) if perms else None), keys


def _wav_store(seed, n_classes=5, per_class=5):
    """1-s clips z-normed with their own log-mel statistics, as a dataset's
    store is. With statistics that leave the input's mean well above its
    spread the JAX package's one-pass BatchNorm variance (E[x^2] - E[x]^2,
    its models/encoders.py:104) loses float32 precision: its step drifts 1e-2
    of the largest |g| from float64 where the port's stays within 5e-5."""
    from audio_few_shot_learning_tpu_torch.ops.mel import MelSpec

    rng = np.random.default_rng(seed)
    wavs = (0.3 * rng.standard_normal((n_classes * per_class, 16000))).astype(np.float32)
    mel = MelSpec("online")(torch.from_numpy(wavs))
    return PackedWavStore.pack(list(wavs), np.repeat(np.arange(n_classes), per_class), mean=float(mel.mean()),
                               std=float(mel.std()), device="cpu")


def _zero_grad(name, exp):
    """Parameters whose gradient is zero but for rounding: the conv biases
    ahead of a train-mode BatchNorm (it removes their mean); without
    attention or the contrastive branch, the head's BatchNorm and Linear
    biases (support and queries shift alike, and distances do not move); the
    relation head's output bias (the softmax of the scores ignores a shift)."""
    if name.startswith("backbone.encoder.conv_encoder.") and name.endswith(".0.bias"):
        return True
    if not exp.use_attention and not exp.use_contrastive and name in (
            "backbone.encoder.logits.1.bias", "backbone.encoder.logits.2.bias"):
        return True
    return exp.relation_head and name == "relation_head.out.bias"


def _port_and_jax(case, seed):
    tpu, _, over, geometry, mdl = STEP_CASES[case]
    d = _step_dict(**tpu)
    d.update(over)
    feat_shape, default_mdl = GEOMETRIES[geometry]
    mdl = mdl or default_mdl
    if not d["use_attention"]:  # the projection then reads encoder features
        mdl = {**mdl, "Projection": {**mdl["Projection"], "input_dim": 64}}
    jexp, jmdl = jcfg.ExperimentConfig.from_dict(d), jcfg.ModelConfig.from_dict(mdl)
    texp, tmdl = tcfg.ExperimentConfig.from_dict(d), tcfg.ModelConfig.from_dict(mdl)
    _, variables = jax_variables(jexp, jmdl, feat_shape, seed=seed)
    store = _wav_store(seed) if texp.input_type == "wav" else _store(feat_shape, seed=seed)
    trainer = Trainer(texp, tmdl, store, val_store=store, test_store=store, seed=seed)
    trainer.model.load_state_dict(from_jax_variables(variables), strict=True)
    ep = sample_episode(torch.Generator().manual_seed(seed), store, N_WAY, K_SHOT, K_QUERY, E)
    rng = np.random.default_rng(seed)
    f, t = feat_shape
    w = texp.specaug_params.W
    draws_s = numpy_draws(rng, E, N_WAY * K_SHOT, f, t, w)
    draws_q = numpy_draws(rng, E, N_WAY * K_QUERY, f, t, w)
    return jexp, jmdl, variables, trainer, ep, draws_s, draws_q


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_train_step_matches_jax(monkeypatch, case):
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
    jexp, jmdl, variables, trainer, ep, draws_s, draws_q = _port_and_jax(case, seed=11)
    chunk = STEP_CASES[case][1]
    ep_np = {k: v.numpy() for k, v in vars(ep).items() if v is not None}  # single segment: no mask
    specaug = trainer.specaug

    def views_of(specs, sl, group):
        if not specaug:
            return specs[:, :, None]
        draws = draws_s if group == "support" else draws_q
        return jax_views(specs, tuple(x[sl] for x in draws))

    store = trainer.train_store
    stats = types.SimpleNamespace(mean=store.mean, std=store.std) if trainer.is_wav else None
    loss, grads, new, perms, keys = _jax_step(jexp, jmdl, variables, ep_np, views_of, chunk, seed=3,
                                              store=stats)

    _no_dropout(trainer.model)
    draws = TrainDraws(perms=None if perms is None else torch.from_numpy(perms))
    if specaug:
        draws.support, draws.query = torch_draws(draws_s), torch_draws(draws_q)
    if trainer.waveaug:  # the chain's draws from each chunk's k_aug_s (engine.py:223-224,262)
        n, s = jexp.waveaug_params.aug_num, N_WAY * K_SHOT
        per_chunk = [jax_episode_chain_draws(jexp.waveaug_params.raw, jexp.dataset_name,
                                             jax.random.split(k, 5)[0], chunk, n, s + N_WAY * K_QUERY,
                                             store.seg_len, jitted=True) for k in keys]
        joined = {name: {k: np.concatenate([p[name][k] for p in per_chunk]) for k in d}
                  for name, d in per_chunk[0].items()}
        draws.wave_support, draws.wave_query = (torch_chain(x) for x in split_chain(joined, s))
    metrics = trainer.train_step(ep, draws)
    assert trainer.step == 1
    np.testing.assert_allclose(float(metrics[0]), loss, rtol=LOSS_RTOL)

    want_g = from_jax_variables({"params": grads, "batch_stats": new["batch_stats"]})
    want = from_jax_variables(new)
    named = [(n, p) for n, p in trainer.model.named_parameters() if p.grad is not None]
    # the reference's unused projection LayerNorms get no gradient, nor the
    # projection itself without the contrastive branch (zero on the JAX side)
    unused = {f"projection_head.{ln}.{w}" for ln in ("ln1", "ln2") for w in ("weight", "bias")}
    if not trainer.aux_loss:
        unused |= {f"projection_head.{fc}.{w}" for fc in ("fc1", "fc2") for w in ("weight", "bias")}
        assert all(not want_g[n].any() for n in unused if "fc" in n)
    assert {n for n, p in trainer.model.named_parameters() if p.grad is None} == unused
    grad_rel, stats_atol = STEP_TOL.get(case, (GRAD_REL, STATS_ATOL))
    for name, p in named:
        g, wg = p.grad.numpy(), want_g[name].numpy()
        got_p, want_p = p.detach().numpy(), want[name].numpy()
        if _zero_grad(name, trainer.exp):
            ref = np.abs(want_g[name.replace(".bias", ".weight")].numpy()).max()
            assert max(np.abs(g).max(), np.abs(wg).max()) < BN_BIAS_NOISE * ref, name
            np.testing.assert_allclose(got_p, want_p, atol=2 * LR, rtol=0, err_msg=name)
            continue
        np.testing.assert_allclose(g, wg, atol=grad_rel * np.abs(wg).max(), rtol=0, err_msg=name)
        big = np.abs(wg) > grad_rel * np.abs(wg).max()
        np.testing.assert_allclose(got_p[big], want_p[big], atol=PARAM_ATOL, rtol=0, err_msg=name)
        np.testing.assert_allclose(got_p[~big], want_p[~big], atol=2 * LR, rtol=0, err_msg=name)
    buffers = dict(trainer.model.named_buffers())
    for name in want:
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(buffers[name].numpy(), want[name].numpy(),
                                       atol=stats_atol, rtol=0, err_msg=name)


@pytest.mark.parametrize("which", ["conv", "head"])
def test_batchnorm_train_path_matches_jax(which):
    """Train-mode BatchNorm against the JAX modules: the conv blocks'
    BandwidthBatchNorm (unbiased variance into the running statistics) and
    the head's flax nn.BatchNorm (biased variance). Outputs 1e-5, running
    statistics 1e-6; eval afterwards applies the moved statistics."""
    rng = np.random.default_rng(5)
    c = 8
    shape = (6, c, 5, 7) if which == "conv" else (6, c)  # six rows: n/(n-1) = 1.2 for the head
    x = (2.0 + 3.0 * rng.standard_normal(shape)).astype(np.float32)
    scale, bias = rng.uniform(0.5, 1.5, c).astype(np.float32), rng.uniform(-0.1, 0.1, c).astype(np.float32)
    mean, var = (0.1 * rng.standard_normal(c)).astype(np.float32), rng.uniform(0.5, 2.0, c).astype(np.float32)
    variables = {"params": {"scale": scale, "bias": bias}, "batch_stats": {"mean": mean, "var": var}}
    if which == "conv":
        xj = np.moveaxis(x, 1, -1)
        out, upd = JaxBandwidthBatchNorm().apply(variables, xj, train=True, mutable=["batch_stats"])
        want = np.moveaxis(np.asarray(out), -1, 1)
        port = BandwidthBatchNorm(c)
    else:
        flax_bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5, dtype=jnp.float32)
        out, upd = flax_bn.apply(variables, x, mutable=["batch_stats"])
        want = np.asarray(out)
        port = HeadBatchNorm(c)
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(scale))
        port.bias.copy_(torch.from_numpy(bias))
        port.running_mean.copy_(torch.from_numpy(mean))
        port.running_var.copy_(torch.from_numpy(var))
    got = port.train()(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(port.running_mean.numpy(), np.asarray(upd["batch_stats"]["mean"]), atol=1e-6)
    np.testing.assert_allclose(port.running_var.numpy(), np.asarray(upd["batch_stats"]["var"]), atol=1e-6)
    assert int(port.num_batches_tracked) == 1
    if which == "conv":  # the recompute of a rematerialized block leaves the statistics alone
        before = (port.running_mean.clone(), port.running_var.clone())
        again = port(torch.from_numpy(x), update_stats=False).detach().numpy()
        np.testing.assert_allclose(again, got, atol=0, rtol=0)
        torch.testing.assert_close((port.running_mean, port.running_var), before, atol=0, rtol=0)
        assert int(port.num_batches_tracked) == 1


def _train_trainer(geometry="small", seed=4, store=None, **over):
    """A CPU trainer on the step test's configuration (dropout on)."""
    d = _step_dict(**over.pop("tpu", {}))
    d.update(over)
    feat_shape, mdl = GEOMETRIES[geometry]
    texp, tmdl = tcfg.ExperimentConfig.from_dict(d), tcfg.ModelConfig.from_dict(mdl)
    store = store if store is not None else _store(feat_shape, seed=seed)
    return Trainer(texp, tmdl, store, val_store=store, test_store=store, seed=seed)


def test_remat_step_equals_plain_step():
    """With remat each conv block is recomputed in the backward: gradients,
    parameters and running statistics equal those of a step without it, and
    every BatchNorm counts one update per chunk, not two."""
    steps = {}
    for remat in (False, True):
        trainer = _train_trainer(tpu={"episode_batch": 2, "episode_microbatch": 1, "remat": remat})
        assert all(b.remat == remat for b in trainer.model.backbone.encoder.conv_encoder)
        ep = sample_episode(torch.Generator().manual_seed(1), trainer.train_store, N_WAY, K_SHOT, K_QUERY, E)
        trainer.train_step(ep)
        steps[remat] = trainer
    plain, remat = steps[False].model, steps[True].model
    for (name, a), (_, b) in zip(plain.named_parameters(), remat.named_parameters()):
        if a.grad is not None:
            torch.testing.assert_close(b.grad, a.grad, atol=1e-6, rtol=1e-6, msg=name)
    torch.testing.assert_close(remat.state_dict(), plain.state_dict(), atol=1e-6, rtol=1e-6)
    counts = [int(m.num_batches_tracked) for m in remat.modules() if hasattr(m, "num_batches_tracked")]
    assert counts == [2] * 5  # 4 conv blocks + the head, 2 chunks


def test_train_epoch_reports_metrics_and_validates():
    trainer = _train_trainer(n_training_tasks=3, tpu={"episode_batch": 1})
    out = trainer.train_epoch()
    assert trainer.step == trainer.steps_per_epoch == 3 and len(trainer.last_step_ms) == 3
    assert all(np.isfinite(out[k]) for k in ("loss", "fsl_loss", "cpl_loss", "episodes_per_sec"))
    np.testing.assert_allclose(out["loss"], out["fsl_loss"] + 1.5 * out["cpl_loss"], rtol=1e-5)
    acc, std = trainer.validate()
    assert 0.0 <= acc <= 1.0 and std >= 0.0 and not trainer.model.training
    # no auxiliary loss: cpl_loss is reported as NaN, as the reference does
    plain = _train_trainer(n_training_tasks=1, loss={"cpl": {"use": False}})
    assert np.isnan(plain.train_epoch()["cpl_loss"])


def test_schedule_reaches_the_optimizer():
    """Over 3 epochs of 2 steps with milestones [1, 2] the optimizer's
    learning rate is lr, lr*g, lr*g^2 per epoch."""
    trainer = _train_trainer(n_training_tasks=2, scheduler_milestones=[1, 2], tpu={"episode_batch": 1},
                             geometry="fprime")
    seen = []
    for _ in range(6):
        ep = sample_episode(trainer.gen, trainer.train_store, N_WAY, K_SHOT, K_QUERY, 1)
        trainer.train_step(ep)
        seen.append(trainer.optimizer.param_groups[0]["lr"])
    np.testing.assert_allclose(seen, [LR, LR, LR / 2, LR / 2, LR / 4, LR / 4], rtol=1e-12)


def test_resume_replays_the_run(tmp_path):
    """2 epochs straight equal 1 epoch, a resume checkpoint, a fresh trainer
    resumed from it and 1 more epoch: the same model, optimizer state, step,
    generator state and epoch-2 metrics, to the bit (dropout on)."""
    from audio_few_shot_learning_tpu_torch.train.experiment import run_single_training

    def trainer(epochs):
        t = _train_trainer(n_training_tasks=2, num_epochs=epochs, geometry="fprime", patience=5,
                           tpu={"episode_batch": 1})
        return t

    logs = []
    straight = run_single_training(trainer(2), str(tmp_path / "a"), log_fn=logs.append)
    run_single_training(trainer(1), str(tmp_path / "b"), log_fn=logs.append)
    resumed = run_single_training(trainer(2), str(tmp_path / "b"), log_fn=logs.append, resume=True)
    assert "Resumed run 0 from epoch 1" in logs
    assert [r["epoch"] for r in resumed["history"]] == [2]
    for key in ("loss", "fsl_loss", "cpl_loss", "val_accuracy"):
        assert resumed["history"][0][key] == straight["history"][1][key], key
    a = torch.load(tmp_path / "a" / "resume_run0.ckpt", weights_only=True)
    b = torch.load(tmp_path / "b" / "resume_run0.ckpt", weights_only=True)
    assert a["step"] == b["step"] == 4
    torch.testing.assert_close(b["model"], a["model"], atol=0, rtol=0)
    torch.testing.assert_close(b["optimizer"]["state"], a["optimizer"]["state"], atol=0, rtol=0)
    assert torch.equal(a["generator"], b["generator"])
    meta = json.loads((tmp_path / "b" / "resume_run0.ckpt.meta.json").read_text())
    assert meta["epoch"] == 2 and meta["early_stopping"]["counter"] in (0, 1)


def test_train_test_cli_completes_a_run(tmp_path):
    """The CLI on a dataset written by the port's make_synthetic_dataset,
    ``"device": "cpu"``: one run of 2 epochs, the reference's files, and a
    best checkpoint that loads into a fresh model."""
    from audio_few_shot_learning_tpu_torch.cli import train_test
    from audio_few_shot_learning_tpu_torch.data.datasets import make_synthetic_dataset
    from audio_few_shot_learning_tpu_torch.models.protonets import FewShotEpisodeModel

    make_synthetic_dataset(tmp_path / "synth", n_classes=9, items_per_class=5, n_mels=48,
                           n_frames=64, split_fractions=(3, 3, 3))
    d = _step_dict(episode_batch=1)
    d.update(dataset_name="synth", data_root=str(tmp_path), n_training_tasks=2, n_testing_tasks=3,
             num_epochs=2, experiment_folder="run", n_way_test=N_WAY)
    d["tpu"]["num_runs"] = 1
    (tmp_path / "exp.json").write_text(json.dumps(d))
    (tmp_path / "mdl.json").write_text(json.dumps(GEOMETRIES["fprime"][1]))
    results = train_test.main(["-e", str(tmp_path / "exp.json"), "-m", str(tmp_path / "mdl.json"),
                               "--experiments-root", str(tmp_path / "experiments")])
    out = tmp_path / "experiments" / "run"
    assert len(results) == 1 and 0.0 <= results[0]["mean_accuracy"] <= 1.0
    assert json.loads((out / "result_run0.json").read_text()) == results[0]
    rows = [json.loads(line) for line in (out / "metrics_run0.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in rows] == [1, 2] and all(r["episodes_per_sec"] > 0 for r in rows)
    assert json.loads((out / "config.json").read_text())["experiment"]["num_epochs"] == 2
    _, _, texp, tmdl, _ = configs("fprime")
    FewShotEpisodeModel(texp, tmdl, (48, 64)).load_state_dict(
        torch.load(out / "model.ckpt", weights_only=True), strict=True)


def test_datasets_match_the_jax_package(tmp_path, jax_native_packer):
    """The port's synthetic dataset writes the JAX package's files, and the
    port's loader packs the split the JAX package packs (both through their
    native packers, to the bit: ``jax_native_packer`` keeps the JAX one off
    its numpy fallback); ``host_store: true`` gives a HostStore of the same
    segments."""
    from audio_few_shot_learning_tpu.data.datasets import MetaAudioDataset as JaxDataset
    from audio_few_shot_learning_tpu.data.datasets import make_synthetic_dataset as jax_make
    from audio_few_shot_learning_tpu_torch.data.datasets import load_packed_split, make_synthetic_dataset

    kw = dict(n_classes=6, items_per_class=3, n_mels=16, n_frames=12, split_fractions=(2, 2, 2), seed=4)
    make_synthetic_dataset(tmp_path / "port", **kw)
    jax_make(tmp_path / "jax", **kw)
    for a in sorted((tmp_path / "jax").rglob("*.npy")):
        b = tmp_path / "port" / a.relative_to(tmp_path / "jax")
        np.testing.assert_array_equal(np.load(b, allow_pickle=True), np.load(a, allow_pickle=True))
    jexp, _, texp, _, _ = configs("small")
    want = JaxDataset(jexp, tmp_path / "jax", "valid").to_packed_store()
    got = load_packed_split(texp, tmp_path / "port", "valid", "cpu")
    np.testing.assert_array_equal(got.segments.numpy(), np.asarray(want.segments))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_array_equal(got.class_counts.numpy(), np.asarray(want.class_counts))
    host = load_packed_split(dataclasses.replace(texp, tpu=dataclasses.replace(texp.tpu, host_store=True)),
                             tmp_path / "port", "valid", "cpu")
    assert isinstance(host, HostStore) and host.is_host_resident
    np.testing.assert_array_equal(host.segments.numpy(), np.asarray(want.segments))
    np.testing.assert_array_equal(host.class_counts, np.asarray(want.class_counts))


def test_wav_train_step_runs_with_one_view():
    """A wav config trains through the log-mel (K3's plain version on the
    CPU) with one view per item and no permutation draws."""
    from audio_few_shot_learning_tpu_torch.data.wavstore import PackedWavStore

    rng = np.random.default_rng(6)
    wavs = list((0.3 * rng.standard_normal((5 * 4, 16000))).astype(np.float32))
    store = PackedWavStore.pack(wavs, np.repeat(np.arange(5), 4), mean=-20.0, std=15.0, device="cpu")
    trainer = _train_trainer(geometry="wav", store=store, input_type="wav", tpu={"episode_batch": 2})
    ep = sample_episode(trainer.gen, store, N_WAY, K_SHOT, K_QUERY, 2)
    metrics = trainer.train_step(ep)
    assert torch.isfinite(metrics).all() and trainer.step == 1


def test_later_slices_raise():
    """What the port refused until it had them now builds a Trainer:
    ``bn_per_view_group``, WaveAugment on wav input (1 + aug_num views),
    the StandardCNN encoder and the relation head. It refuses a mesh of
    more than one device outside a process group (naming torchrun: the
    data-parallel path is tests/test_torch_port_parallel.py) and a
    microbatch that does not divide the batch."""
    grouped = _train_trainer(tpu={"bn_per_view_group": True})
    assert grouped.exp.tpu.bn_per_view_group and grouped.v_support == 4
    wav = _train_trainer(geometry="wav", store=_wav_store(6), input_type="wav",
                         waveaug_params={"use": True, "aug_num": 2})
    assert wav.waveaug and wav.v_support == wav._v_query(True) == 3 and wav._v_query(False) == 1
    assert _train_trainer(encoder_name="CNN").model.backbone.encoder.out_dim == 64
    assert hasattr(_train_trainer(relation_head=True).model, "relation_head")
    with pytest.raises(RuntimeError, match="mesh_shape=2 .*torchrun"):
        _train_trainer(tpu={"mesh_shape": 2})
    assert _train_trainer(tpu={"mesh_shape": 1}).device.type == "cpu"
    with pytest.raises(ValueError, match="must divide"):
        _train_trainer(tpu={"episode_batch": 3, "episode_microbatch": 2})
