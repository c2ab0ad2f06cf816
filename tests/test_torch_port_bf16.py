"""PyTorch port: the shipped configs' precision, ``compute_dtype: "bfloat16"``,
held against the JAX package on the CPU.

Every shipped experiment config runs in bfloat16, and the two packages round
in different places there (the conv bias: JAX rounds the conv output, then
adds a bf16 bias, the port adds it inside the conv; train-mode BatchNorm:
JAX applies ``x * inv + shift`` with ``inv`` and ``shift`` rounded to bf16,
the port's ``F.batch_norm`` rounds once; max-pool: at 8 mantissa bits a 3x3
window often holds tied maxima, and each framework routes the backward to
another of them, both valid subgradients). So the two bf16 results differ
by more than either differs from float32, and no fixed tolerance between
them says whether the port rounds worse. Each quantity is therefore held by
its error against a truth: the port's float64 result on the same weights,
inputs and draws (the port's float64 is within the float32 tests' tolerances
of the JAX package). With ``err_jax`` the JAX bf16 result's distance from
the truth and ``err_port`` the port bf16 result's:

* ``err_port <= C * err_jax``, C = 1.5, for the largest and the RMS
  element error;
* ``max|port - jax| <= err_port + err_jax + SLACK`` (SLACK = 1e-6);
* argmax agreement with the truth: a row whose argmax the port misses and
  the JAX package hits has a float64 top-two margin under 2 x err_jax
  (a tie that the JAX package's own rounding could split as well); the
  vote's accuracy is no further from the truth's than the JAX package's.

A train step is held leaf by leaf, then per case: each gradient leaf's
error as a share of its largest float64 |g| (as ``STEP_TOL`` does), the
case's figure the largest and the RMS over the leaves; the updated
parameters as the RMS over all entries of the difference over lr (Adam's
first step is ~lr x sign(g), so this counts flipped signs); the running
statistics' largest and RMS error; the loss's error as the RMS over the
step and 7 more episode batches of that configuration (one scalar alone
gives a ratio of two noise draws). The conv biases ahead of a train-mode
BatchNorm (gradient zero but for rounding) are held by their share of the
same conv weight's largest |g|.

Measured (this file's seeds, on the CPU; err_jax / err_port, the largest
element error, then the RMS):

(a) Hybrid backbone features in eval, 24 items (scale: largest |x| 0.15
    small, 0.42 fprime): small folded 1.35e-3 / 1.13e-3, 3.03e-4 /
    2.92e-4; small unfolded 2.07e-3 / 1.44e-3, 4.58e-4 / 4.19e-4; fprime
    folded 1.22e-3 / 1.24e-3, 3.23e-4 / 3.64e-4; fprime unfolded 1.99e-3 /
    1.54e-3, 5.15e-4 / 4.84e-4.
(b) episode model, small, E=4, 12 queries, 4 views. With attention
    (scores' scale 2.4): query features 2.19e-2 / 1.72e-2, 3.21e-3 /
    2.67e-3; scores 3.98e-2 / 3.06e-2, 1.44e-2 / 1.18e-2; argmax agreement
    1.0 / 0.979 (the one row the port misses has a float64 top-two margin
    of 7.4e-3). Without (scale 0.12): query features 1.93e-3 / 1.46e-3,
    3.84e-4 / 3.34e-4; scores 5.70e-3 / 4.76e-3, 1.45e-3 / 1.40e-3; argmax
    0.969 / 0.979.
(c) one multi-segment batch, E=2, s_max 3, the 26 real query rows (scale
    1.8): scores 5.05e-2 / 4.27e-2, 2.00e-2 / 1.29e-2; argmax 0.923 /
    0.962; the votes' accuracy off the truth's by 0.33 / 0.17 (summed over
    the 2 episodes) for each tie strategy.
(d) one train step. Gradients: share of the leaf's largest |g|, largest
    and RMS over the leaves; conv biases ahead of BatchNorm: share of their
    conv weight's largest |g|; parameters: RMS of the difference / lr;
    running statistics: largest and RMS; loss: largest and RMS over 8
    batches (scale 2-8).

    case          gradients          conv biases    params / lr   statistics           loss
    flagship CPL  1.10 / 0.68,       0.155 / 0.004  0.372 / 0.323 6.7e-4 / 4.9e-4,     0.161 / 0.091,
                  0.26 / 0.20                                     2.3e-4 / 1.3e-4      0.088 / 0.055
    apl_anchors   0.54 / 0.38,       0.168 / 0.003  0.492 / 0.406 the same             0.174 / 0.113,
                  0.25 / 0.17                                                          0.070 / 0.077
    plain         0.44 / 0.43,       0.175 / 0.033  0.469 / 0.411 7.1e-4 / 9.8e-4,     0.053 / 0.033,
                  0.23 / 0.17                                     1.8e-4 / 1.8e-4      0.026 / 0.020
    tpu1-1        0.89 / 0.44,       0.141 / 0.006  0.406 / 0.371 1.1e-3 / 1.3e-3,     0.140 / 0.116,
                  0.25 / 0.16                                     3.0e-4 / 3.4e-4      0.074 / 0.066

    A bf16 step's gradients are far from float64 on both sides; the
    port's are of the JAX package's size or smaller. The largest leaf
    errors: flagship, JAX block 0's BatchNorm bias (1.10), the port the
    projection's fc1 bias (0.68: its rows' gradients nearly cancel while
    the bf16 features move each row's); plain, both in blocks 0-1 (conv
    weights, BatchNorm affines). There max-pool tie routing is one source
    among the bf16 activations' own error: 0.5% (block 0) to 1.6% (block 3)
    of the positive 3x3 windows of the small geometry's bf16 train-mode
    maps hold a tied maximum, and each framework sends that window's
    gradient to another of them. It does not set the comparison (the port
    stays under the JAX package there, 0.43 vs 0.44), so no tie-free input
    was needed. The conv biases' rounding noise is 5-50x smaller in the
    port, which adds the bias inside the convolution.
(e) five flagship steps from the same weights and episodes: loss error
    0.180 / 0.136 (largest), 0.116 / 0.076 (RMS over the steps); the final
    parameters 0.448 / 0.386 lr (RMS).

The largest ratio err_port / err_jax is 1.39 (plain's running statistics,
largest entry; their RMS ratio is 0.97). No port function was found with
a bf16 error above C x the JAX package's.

Randomness enters as data, as in the float32 tests: episodes from a torch
Generator, views and permutations given to both packages, every dropout the
identity, CPL at M = class size. The JAX step is jitted once per
configuration with its data as arguments.
"""

import functools
import types

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_port_helpers import configs, jax_variables, jax_views, numpy_draws, port_model, torch_draws
from audio_few_shot_learning_tpu import config as jcfg
from audio_few_shot_learning_tpu.data.episodes import EpisodeBatch as JaxEpisodeBatch
from audio_few_shot_learning_tpu.models.protonets import FewShotEpisodeModel as JaxModel
from audio_few_shot_learning_tpu.ops.specaugment import _views_xla
from audio_few_shot_learning_tpu.train.engine import Trainer as JaxTrainer
from audio_few_shot_learning_tpu.train.state import make_optimizer as jax_make_optimizer
from audio_few_shot_learning_tpu_torch import config as tcfg
from audio_few_shot_learning_tpu_torch.data.episodes import sample_episode
from audio_few_shot_learning_tpu_torch.train.engine import Trainer, TrainDraws, _slice_tree
from audio_few_shot_learning_tpu_torch.train.weights import from_jax_variables
from test_torch_port_multiseg import STRATEGIES, _multiseg_spec_store
from test_torch_port_train import (
    E, GEOMETRIES, K_QUERY, K_SHOT, LR, N_WAY, STEP_CASES, _no_dropout, _step_dict, _store, _zero_grad,
)

C = 1.5
SLACK = 1e-6
LOSS_BATCHES = 8  # the step's batch and 7 more, for the loss's error
TRAJECTORY_STEPS = 5


def _err(x, truth):
    d = np.asarray(x, np.float64) - np.asarray(truth, np.float64)
    return np.abs(d).max(), np.sqrt(np.mean(np.square(d)))


def hold(name, port, jax_, truth):
    """C and the triangle bound on the largest and the RMS element error;
    returns ((jax max, jax rms), (port max, port rms))."""
    ej, ep = _err(jax_, truth), _err(port, truth)
    for k, what in enumerate(("largest", "RMS")):
        assert ep[k] <= C * ej[k], f"{name}: port's {what} bf16 error {ep[k]:.3g} > {C} x JAX's {ej[k]:.3g}"
    gap = _err(port, jax_)[0]
    assert gap <= ep[0] + ej[0] + SLACK, f"{name}: port vs JAX {gap:.3g}"
    return ej, ep


def hold_argmax(name, port, jax_, truth, err_jax):
    """Every row the port's argmax misses and the JAX package's hits is a
    near tie of the truth's (top-two margin under 2 x err_jax)."""
    port, jax_, truth = (np.asarray(a, np.float64) for a in (port, jax_, truth))
    want = truth.argmax(-1)
    top2 = np.sort(truth, -1)[..., -2:]
    lost = (port.argmax(-1) != want) & (jax_.argmax(-1) == want)
    margins = (top2[..., 1] - top2[..., 0])[lost]
    assert (margins < 2 * err_jax).all(), f"{name}: port misses rows of margin {margins} (err_jax {err_jax:.3g})"
    return (jax_.argmax(-1) == want).mean(), (port.argmax(-1) == want).mean()


# ---------------------------------------------------------------------------
# (a)-(c) evaluation
# ---------------------------------------------------------------------------


def _eval_models(geometry, use_attention=True, fold=True, seed=0):
    """(JAX model and variables at bf16, port bf16, port float64)."""
    jexp, jmdl, texp, tmdl, feat_shape = configs(geometry, use_attention, fold, "bfloat16")
    jmodel, variables = jax_variables(jexp, jmdl, feat_shape, seed=seed)
    _, _, texp64, tmdl64, _ = configs(geometry, use_attention, fold, "float64")
    port = port_model(texp, tmdl, feat_shape, variables)
    truth = port_model(texp64, tmdl64, feat_shape, variables).double()
    return jmodel, variables, port, truth, feat_shape


@pytest.mark.parametrize("geometry", ["small", "fprime"])
@pytest.mark.parametrize("fold", [True, False], ids=["folded", "unfolded"])
def test_backbone_eval_bf16_error(geometry, fold):
    jmodel, variables, port, truth, (f, t) = _eval_models(geometry, fold=fold)
    x = np.random.default_rng(1).standard_normal((24, f, t)).astype(np.float32)
    want = jax.jit(lambda v, x: jmodel.apply(v, x, train=False, method=lambda m, x, train: m.backbone(x, train))
                   )(variables, x)
    with torch.no_grad():
        got = port.backbone(torch.from_numpy(x))
        ref = truth.backbone(torch.from_numpy(x).double())
    assert got.dtype == torch.float32 and got.shape == ref.shape == want.shape
    hold(f"{geometry} fold={fold} features", got.numpy(), want, ref.numpy())


@pytest.mark.parametrize("use_attention", [True, False], ids=["attention", "no_attention"])
def test_episode_scores_bf16_error(use_attention):
    jmodel, variables, port, truth, (f, t) = _eval_models("small", use_attention)
    rng = np.random.default_rng(4)
    e, shots, queries, v = 4, 2, 4, 4
    sup = rng.standard_normal((e, N_WAY * shots, v, f, t)).astype(np.float32)
    qry = rng.standard_normal((e, N_WAY * queries, v, f, t)).astype(np.float32)
    labels = np.tile(np.repeat(np.arange(N_WAY), shots), (e, 1))
    want = jax.jit(lambda v_, s_, q_, l_: jmodel.apply(v_, s_, q_, l_, N_WAY, train=False))(variables, sup, qry, labels)
    with torch.no_grad():
        got = port(torch.from_numpy(sup), torch.from_numpy(qry), torch.from_numpy(labels), N_WAY)
        ref = truth(torch.from_numpy(sup).double(), torch.from_numpy(qry).double(), torch.from_numpy(labels), N_WAY)
    hold("query features", got.query_features.numpy(), want.query_features, ref.query_features.numpy())
    ej, _ = hold("scores", got.scores.numpy(), want.scores, ref.scores.numpy())
    hold_argmax("scores", got.scores.numpy(), want.scores, ref.scores.numpy(), ej[0])


def test_multiseg_eval_batch_bf16_error():
    """One multi-segment eval batch of the flagship structure: the scores of
    the real rows and the vote's accuracy for every tie strategy."""
    jexp, jmdl, texp, tmdl, (f, t) = configs("small", compute_dtype="bfloat16")
    _, _, texp64, tmdl64, _ = configs("small", compute_dtype="float64")
    jmodel, variables = jax_variables(jexp, jmdl, (f, t), seed=51)
    store = _multiseg_spec_store((f, t))
    port = Trainer(texp, tmdl, store, test_store=store)
    truth = Trainer(texp64, tmdl64, store, test_store=store)
    truth.model.double()
    for trainer in (port, truth):
        trainer.model.load_state_dict(from_jax_variables(variables), strict=True)
    e = 2
    ep = sample_episode(torch.Generator().manual_seed(7), store, N_WAY, K_SHOT, K_QUERY, e, is_test=True)
    rng = np.random.default_rng(8)
    draws_s = numpy_draws(rng, e, N_WAY * K_SHOT, f, t, texp.specaug_params.W)
    draws_q = numpy_draws(rng, e, ep.query.shape[1], f, t, texp.specaug_params.W)
    draws = (torch_draws(draws_s), torch_draws(draws_q))
    with torch.inference_mode():
        got = port._episode_scores(ep, N_WAY, True, port.gen, draws).numpy()
        ref = truth._episode_scores(ep, N_WAY, True, truth.gen, draws).numpy()
    fn = jax.jit(lambda v, s, q, lab: jmodel.apply(v, s, q, lab, N_WAY, train=False).scores)
    want = np.asarray(fn(variables, jax_views(ep.support.numpy(), draws_s), jax_views(ep.query.numpy(), draws_q),
                         ep.support_labels.numpy()))
    real = ep.query_mask.numpy().astype(bool)
    ej, _ = hold("multi-segment scores", got[real], want[real], ref[real])
    hold_argmax("multi-segment scores", got[real], want[real], ref[real], ej[0])
    for tie in STRATEGIES:
        acc = {k: Trainer.vote_accuracy(torch.from_numpy(np.asarray(s, np.float64)), ep, N_WAY, tie,
                                        store.s_max).numpy() for k, s in (("jax", want), ("port", got), ("truth", ref))}
        off_jax, off_port = (np.abs(acc[k] - acc["truth"]).sum() for k in ("jax", "port"))
        assert off_port <= off_jax, f"vote ({tie!r}): port {acc['port']}, JAX {acc['jax']}, truth {acc['truth']}"


# ---------------------------------------------------------------------------
# (d)-(e) training
# ---------------------------------------------------------------------------


def _step_configs(case, dtype):
    tpu, _, over, geometry, mdl = STEP_CASES[case]
    d = _step_dict(**tpu)
    d.update(over)
    d["tpu"]["compute_dtype"] = dtype
    feat_shape, default_mdl = GEOMETRIES[geometry]
    mdl = mdl or default_mdl
    if not d["use_attention"]:  # the projection then reads encoder features
        mdl = {**mdl, "Projection": {**mdl["Projection"], "input_dim": 64}}
    return d, mdl, feat_shape


class _JaxSteps:
    """The JAX package's train step for one configuration, its data as
    arguments: per chunk ``value_and_grad`` of ``Trainer._loss_and_metrics``
    with the views given, BatchNorm statistics carried from chunk to chunk,
    gradients and loss averaged over the chunks (engine.py:359-383), then
    optax Adam with its state carried from step to step."""

    def __init__(self, case):
        d, mdl, _ = _step_configs(case, "bfloat16")
        self.exp = jcfg.ExperimentConfig.from_dict(d)
        self.chunk = STEP_CASES[case][1]
        spec_aug = self.exp.specaug_params.use
        self.vq = 4 if spec_aug and self.exp.train_query_augmentations else 1
        fake = types.SimpleNamespace(exp=self.exp, is_wav=False, model=JaxModel(exp=self.exp,
                                     mdl=jcfg.ModelConfig.from_dict(mdl)), specaug=spec_aug)

        def loss(params, stats, batch, key):
            views = [batch["views_s"], batch["views_q"]]
            fake._make_views = lambda specs, k, enabled: views.pop(0)
            jep = JaxEpisodeBatch(
                support=batch["support"], support_labels=batch["support_labels"], query=batch["query"],
                query_labels=batch["query_labels"], audio_ids=jnp.zeros(batch["query"].shape[:2], jnp.int32),
                query_mask=jnp.ones(batch["query"].shape[:2]))
            total, (metrics, new_stats) = JaxTrainer._loss_and_metrics(fake, params, stats, jep, key, N_WAY,
                                                                       self.vq, None)
            return total, (metrics["loss"], new_stats)

        self.grad = jax.jit(jax.value_and_grad(loss, has_aux=True))
        self.opt = jax_make_optimizer(LR, self.exp.scheduler_milestones, self.exp.scheduler_gamma, 1)

        @jax.jit  # one compile for the average and the update, not one per leaf shape
        def update(grads, opt_state, params):
            mean = jax.tree.map(lambda *gs: functools.reduce(jnp.add, gs) / len(gs), *grads)
            upd, opt_state = self.opt.update(mean, opt_state, params)
            return mean, optax.apply_updates(params, upd), opt_state

        self.update = update

    def step(self, params, stats, opt_state, batches, keys):
        """One step over its chunks; returns (loss, grads, params, stats, opt_state)."""
        grads, losses = [], []
        for batch, key in zip(batches, keys):
            (_, (loss, stats)), g = self.grad(params, stats, batch, key)
            grads.append(g)
            losses.append(float(loss))
        mean, params, opt_state = self.update(grads, opt_state, params)
        return np.mean(losses), mean, params, stats, opt_state


_JAX_STEPS = {}
# jitted forms of the helpers' eager jax_views and the train tests' _jax_perms
# (eager, each call re-traces: seconds per case)
_views = jax.jit(jax.vmap(lambda s, y, t, f: _views_xla(s, y, t, f, 0.0)))


@functools.partial(jax.jit, static_argnums=(1, 2))
def _perms(key, e, v):
    """The view permutations the JAX package's loss draws from ``key``."""
    k_perm = jax.random.split(key, 5)[3]
    return jax.vmap(lambda k: jax.random.permutation(k, jnp.arange(1, v)))(jax.random.split(k_perm, e))


def _jax_steps(case):
    if case not in _JAX_STEPS:
        _JAX_STEPS[case] = _JaxSteps(case)
    return _JAX_STEPS[case]


class _Run:
    """One configuration's bf16 port, float64 port and bf16 JAX copies from
    the same weights, fed the same episodes, views and permutations."""

    def __init__(self, case, seed=11):
        self.case = case
        _, _, feat_shape = _step_configs(case, "bfloat16")
        self.feat_shape = feat_shape
        self.store = _store(feat_shape, seed=seed)
        self.trainers = {}
        variables = None
        for dtype in ("bfloat16", "float64"):
            d, mdl, _ = _step_configs(case, dtype)
            texp, tmdl = tcfg.ExperimentConfig.from_dict(d), tcfg.ModelConfig.from_dict(mdl)
            if variables is None:
                _, variables = jax_variables(jcfg.ExperimentConfig.from_dict(d), jcfg.ModelConfig.from_dict(mdl),
                                             feat_shape, seed=seed)
            trainer = Trainer(texp, tmdl, self.store, val_store=self.store, test_store=self.store, seed=seed)
            if dtype == "float64":
                trainer.model.double()
            trainer.model.load_state_dict(from_jax_variables(variables), strict=True)
            _no_dropout(trainer.model)
            self.trainers[dtype] = trainer
        self.jax = _jax_steps(case)
        self.params, self.stats = variables["params"], variables["batch_stats"]
        self.opt_state = self.jax.opt.init(self.params)
        self.gen = torch.Generator().manual_seed(seed)
        self.rng = np.random.default_rng(seed)
        self.steps = 0

    def batch(self):
        """An episode batch with its views (JAX: per chunk) and draws (port)."""
        ep = sample_episode(self.gen, self.store, N_WAY, K_SHOT, K_QUERY, E)
        f, t = self.feat_shape
        w = self.trainers["bfloat16"].exp.specaug_params.W
        d_s = numpy_draws(self.rng, E, N_WAY * K_SHOT, f, t, w)
        d_q = numpy_draws(self.rng, E, N_WAY * K_QUERY, f, t, w)
        chunk, vq = self.jax.chunk, self.jax.vq
        batches, keys, perms = [], [], []
        for c in range(E // chunk):
            sl = slice(c * chunk, (c + 1) * chunk)
            sup, qry = ep.support[sl].numpy(), ep.query[sl].numpy()
            spec_aug = self.jax.exp.specaug_params.use
            batches.append(dict(
                support=sup, query=qry, support_labels=ep.support_labels[sl].numpy(),
                query_labels=ep.query_labels[sl].numpy(),
                views_s=_views(sup, *(x[sl] for x in d_s)) if spec_aug else sup[:, :, None],
                views_q=_views(qry, *(x[sl] for x in d_q)) if vq > 1 else qry[:, :, None]))
            keys.append(jax.random.PRNGKey(1000 * self.steps + c))
            if vq > 1:
                perms.append(np.asarray(_perms(keys[-1], chunk, vq)))
        draws = TrainDraws(perms=torch.from_numpy(np.concatenate(perms)) if perms else None)
        if self.trainers["bfloat16"].specaug:
            draws.support, draws.query = torch_draws(d_s), torch_draws(d_q)
        return ep, draws, batches, keys

    def step(self):
        """One step on all three copies: {"jax" | "port" | "truth": (loss,
        gradients by port name, state_dict as float64 numpy)}."""
        ep, draws, batches, keys = self.batch()
        loss, grads, self.params, self.stats, self.opt_state = self.jax.step(
            self.params, self.stats, self.opt_state, batches, keys)
        out = {"jax": (loss, {k: v.numpy() for k, v in from_jax_variables(
            {"params": jax.tree.map(np.asarray, grads), "batch_stats": jax.tree.map(np.asarray, self.stats)}).items()},
            {k: v.numpy() for k, v in from_jax_variables(
                {"params": jax.tree.map(np.asarray, self.params),
                 "batch_stats": jax.tree.map(np.asarray, self.stats)}).items()})}
        for name, dtype in (("port", "bfloat16"), ("truth", "float64")):
            trainer = self.trainers[dtype]
            loss = float(trainer.train_step(ep, draws)[0])
            grads = {n: p.grad.double().numpy() for n, p in trainer.model.named_parameters() if p.grad is not None}
            out[name] = (loss, grads, {k: v.double().numpy() for k, v in trainer.model.state_dict().items()})
        self.steps += 1
        return out

    def losses(self):
        """The loss of one more batch on the three copies, at the weights
        they hold (no update)."""
        ep, draws, batches, keys = self.batch()
        self.steps += 1
        grad = self.jax.grad
        out = {"jax": float(np.mean([grad(self.params, self.stats, b, k)[0][1][0] for b, k in zip(batches, keys)]))}
        for name, dtype in (("port", "bfloat16"), ("truth", "float64")):
            trainer = self.trainers[dtype]
            state = {k: v.clone() for k, v in trainer.model.state_dict().items()}
            trainer.model.train()
            chunk = self.jax.chunk
            with torch.no_grad():
                out[name] = float(np.mean([
                    trainer._loss_and_metrics(_slice_tree(ep, sl), _slice_tree(draws, sl))[0].item()
                    for sl in (slice(c, c + chunk) for c in range(0, E, chunk))]))
            trainer.model.load_state_dict(state)  # the forward moved the running statistics
        return out


def _params_over_lr(state, truth, names):
    d = np.concatenate([(state[n] - truth[n]).ravel() for n in names])
    return np.sqrt(np.mean(np.square(d))) / LR


def _grad_shares(grads, truth, exp):
    """Per-leaf error as a share of the leaf's largest float64 |g|; the conv
    biases ahead of a train-mode BatchNorm by their conv weight's."""
    shares, bias_noise = [], []
    for n, g in truth.items():
        if _zero_grad(n, exp):
            bias_noise.append(np.abs(grads[n]).max() / np.abs(truth[n.replace(".bias", ".weight")]).max())
            continue
        scale = np.abs(g).max()
        if scale == 0.0:  # the recurrent weight at T' = 1
            assert not grads[n].any(), n
            continue
        shares.append(np.abs(grads[n] - g).max() / scale)
    shares = np.array(shares)
    return (shares.max(), np.sqrt(np.mean(shares ** 2))), max(bias_noise, default=0.0)


@pytest.mark.parametrize("case", ["tpu0-2", "apl_anchors", "plain", "tpu1-1"])
def test_train_step_bf16_error(monkeypatch, case):
    """One bf16 train step against float64: the loss, every gradient, the
    parameters after the Adam step and the running statistics."""
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
    run = _Run(case)
    out = run.step()
    exp = run.trainers["float64"].exp
    (_, g_truth, s_truth) = out["truth"]
    g_err = {k: _grad_shares(out[k][1], g_truth, exp) for k in ("jax", "port")}
    for i, what in enumerate(("largest", "RMS")):
        assert g_err["port"][0][i] <= C * g_err["jax"][0][i], (what, g_err)
    assert g_err["port"][1] <= C * g_err["jax"][1] + SLACK, g_err
    for n in g_truth:
        port, jax_ = out["port"][1][n], out["jax"][1][n]
        bound = np.abs(port - g_truth[n]).max() + np.abs(jax_ - g_truth[n]).max() + SLACK
        assert np.abs(port - jax_).max() <= bound, n

    params = [n for n in g_truth]
    p_err = {k: _params_over_lr(out[k][2], s_truth, params) for k in ("jax", "port")}
    assert p_err["port"] <= C * p_err["jax"], p_err
    stats = [n for n in s_truth if n.endswith(("running_mean", "running_var"))]
    hold("running statistics", np.concatenate([out["port"][2][n].ravel() for n in stats]),
         np.concatenate([out["jax"][2][n].ravel() for n in stats]), np.concatenate([s_truth[n].ravel() for n in stats]))

    losses = [{k: out[k][0] for k in out}] + [run.losses() for _ in range(LOSS_BATCHES - 1)]
    hold("loss", [x["port"] for x in losses], [x["jax"] for x in losses], [x["truth"] for x in losses])


def test_five_bf16_steps_track_float64(monkeypatch):
    """Five consecutive flagship steps from the same weights and episodes:
    the loss trajectories and the final parameters within the bf16 error of
    each other."""
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
    run = _Run("tpu0-2", seed=5)
    outs = [run.step() for _ in range(TRAJECTORY_STEPS)]
    hold("loss trajectory", [o["port"][0] for o in outs], [o["jax"][0] for o in outs], [o["truth"][0] for o in outs])
    final = outs[-1]
    params = list(final["truth"][1])
    p_err = {k: _params_over_lr(final[k][2], final["truth"][2], params) for k in ("jax", "port")}
    assert p_err["port"] <= C * p_err["jax"], p_err
