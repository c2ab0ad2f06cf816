"""PyTorch port: episode-axis data parallelism against the JAX package's
episode mesh, on the CPU.

Ranks are processes in a gloo group (``parallel/spawn.py::run_ranks``: a
``file://`` rendezvous in a fresh temporary directory, each spawn with its
own time limit, ``SPAWN_TIMEOUT_S``); they run
``tests/_torch_port_parallel_worker.py``, which imports no JAX.

* One train step on W ranks against the JAX ``Trainer``'s step sharded over
  a W-device mesh of the virtual CPU devices (``_shard_episodes``): 4 ranks
  of one episode each, and 2 ranks with ``episode_microbatch=2`` (each chunk
  spread over the ranks). Same weights, episodes, views and view
  permutations as data, dropout the identity on both sides, CPL at M =
  class size; the tolerances of ``tests/test_torch_port_train.py``: loss
  1e-4 relative, each gradient 1e-4 of its tensor's largest |g| (the conv
  biases ahead of a BatchNorm, zero but for rounding, under 1e-2 of their
  conv weight's), running statistics 1e-6, parameters after Adam 1e-3 x lr
  where the gradient's sign is sure and 2 x lr elsewhere. Every rank ends
  with the same parameters, to the bit.
* A one-rank mesh in a group against a Trainer outside any group, 3 sampled
  steps from one seed: bit-equal (the mean over one rank divides by 1).
* The BatchNorm combine: W ranks' train-mode BatchNorm (both classes) equals
  one process's over the concatenated rows, uneven counts and the
  ill-conditioned mean 2.6 / spread 0.31 included: outputs and input
  gradients 1e-4 of their largest, the affine's gradient summed over ranks
  1e-4, running statistics 1e-6; the grouped path and eval issue no
  collective.
* The eval gather: 7 fixed episodes over 4 ranks, single and multi-segment
  under each tie strategy, equal to one process's accuracies, to the bit.
* ``cli.train_test`` on 2 ranks: rank 0 alone writes, both ranks train the
  same epochs, and ``--resume`` replays the run.
* The mesh outside a group, the import scan, and the dry run.
"""

import ast
import functools
import json
import os
import pathlib
import types

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import _torch_port_parallel_worker as worker
from _torch_port_helpers import GEOMETRIES, exp_dict, jax_variables, jax_views, numpy_draws
from audio_few_shot_learning_tpu import config as jcfg
from audio_few_shot_learning_tpu.data.episodes import EpisodeBatch as JaxEpisodeBatch
from audio_few_shot_learning_tpu.models.protonets import FewShotEpisodeModel as JaxModel
from audio_few_shot_learning_tpu.parallel.mesh import episode_sharding
from audio_few_shot_learning_tpu.parallel.mesh import make_mesh as jax_make_mesh
from audio_few_shot_learning_tpu.train.engine import Trainer as JaxTrainer
from audio_few_shot_learning_tpu.train.state import make_optimizer as jax_make_optimizer
from audio_few_shot_learning_tpu_torch import config as tcfg
from audio_few_shot_learning_tpu_torch.data.episodes import sample_episode
from audio_few_shot_learning_tpu_torch.models.encoders import BandwidthBatchNorm, HeadBatchNorm
from audio_few_shot_learning_tpu_torch.parallel import dryrun
from audio_few_shot_learning_tpu_torch.parallel.mesh import EpisodeMesh, make_mesh, maybe_initialize_distributed
from audio_few_shot_learning_tpu_torch.parallel.spawn import run_ranks
from audio_few_shot_learning_tpu_torch.train.engine import Trainer
from audio_few_shot_learning_tpu_torch.train.weights import from_jax_variables

REPO = pathlib.Path(__file__).resolve().parents[1]
SPAWN_TIMEOUT_S = 120
N_WAY, K_SHOT, K_QUERY, V = 3, 2, 2, 4
LR = 1e-3
LOSS_RTOL, GRAD_REL, BN_BIAS_NOISE, STATS_ATOL, PARAM_ATOL = 1e-4, 1e-4, 1e-2, 1e-6, 1e-3 * LR
BN_REL = 1e-4
# The conv-0 weight gradient is a reduction over ~1.8M terms (E=4 x 48 view
# rows x 96x99): the port's float32 step on the CPU is 1.0-1.2e-4 of its
# largest |g| off a float64 step of the same model there, one process or two
# ranks in chunks alike (the JAX package's sharded step: 1.5e-5), so in the
# chunked case it is held to 2e-4; every other gradient to GRAD_REL.
CASE_GRAD_REL = {"2_ranks_microbatch_2": {"backbone.encoder.conv_encoder.0.0.weight": 2e-4}}


def _ranks(fn, world, *args):
    return run_ranks(fn, world, args, timeout_s=SPAWN_TIMEOUT_S, threads=1)


def _step_dict(e, **tpu):
    d = exp_dict(
        n_way_train=N_WAY, n_shot_train=K_SHOT, n_query_train=K_QUERY,
        n_way_validation=N_WAY, n_shot_validation=K_SHOT, n_query_validation=K_QUERY,
        n_training_tasks=e, lr=LR, scheduler_milestones=[1], scheduler_gamma=0.5,
        loss={"l_param": 1.5, "cpl": {"use": True, "m_param": K_QUERY, "t_param": 2.0}},
    )
    d["tpu"].update({"episode_batch": e, **tpu})
    return d


def _jax_perms(key, e):
    k_perm = jax.random.split(key, 5)[3]
    return np.asarray(jax.vmap(lambda k: jax.random.permutation(k, jnp.arange(1, V)))(jax.random.split(k_perm, e)))


def _jax_sharded_step(jexp, jmdl, variables, ep, views, world, chunk, seed):
    """The JAX package's train step with its episodes sharded over a
    ``world``-device mesh: per chunk, value_and_grad of
    ``Trainer._loss_and_metrics`` on episodes put through the Trainer's
    ``_shard_episodes`` (views given as data, sharded alike), statistics
    carried from chunk to chunk, gradients and metrics averaged over the
    chunks (engine.py:359-383), then the optax Adam update."""
    sharding = episode_sharding(jax_make_mesh(world))
    fake = types.SimpleNamespace(exp=jexp, is_wav=False, specaug=True, model=JaxModel(exp=jexp, mdl=jmdl),
                                 _ep_sharding=sharding)
    params, stats = variables["params"], variables["batch_stats"]
    e = ep["support"].shape[0]
    grads, losses, perms = [], [], []

    def loss(p, st, jep, sup_v, qry_v, key):
        jep = JaxTrainer._shard_episodes(fake, jep)
        pending = [jax.lax.with_sharding_constraint(v, sharding) for v in (sup_v, qry_v)]
        fake._make_views = lambda specs, k, enabled: pending.pop(0)
        return JaxTrainer._loss_and_metrics(fake, p, st, jep, key, N_WAY, V)

    value_and_grad = jax.jit(jax.value_and_grad(loss, has_aux=True))
    for c in range(e // chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        put = lambda x: jax.device_put(jnp.asarray(x), sharding)  # noqa: E731
        jep = JaxEpisodeBatch(
            support=put(ep["support"][sl]), support_labels=put(ep["support_labels"][sl]),
            query=put(ep["query"][sl]), query_labels=put(ep["query_labels"][sl]),
            audio_ids=put(np.zeros(ep["query"][sl].shape[:2], np.int32)),
            query_mask=put(np.ones(ep["query"][sl].shape[:2], np.float32)),
        )
        sup_v, qry_v = put(views["support"][sl]), put(views["query"][sl])
        key = jax.random.PRNGKey(seed + c)
        perms.append(_jax_perms(key, chunk))
        (_, (metrics, stats)), g = value_and_grad(params, stats, jep, sup_v, qry_v, key)
        grads.append(g)
        losses.append(float(metrics["loss"]))
    chunks = len(grads)
    opt = jax_make_optimizer(LR, jexp.scheduler_milestones, jexp.scheduler_gamma, 1)

    @jax.jit
    def average_and_update(grads, params):
        mean = jax.tree.map(lambda *gs: functools.reduce(jnp.add, gs) / chunks, *grads)
        upd, _ = opt.update(mean, opt.init(params), params)
        return mean, optax.apply_updates(params, upd)

    grads, new_params = average_and_update(grads, params)
    tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return np.mean(losses), tree(grads), tree({"params": new_params, "batch_stats": stats}), np.concatenate(perms)


def _zero_grad(name):
    """The conv biases ahead of a train-mode BatchNorm: zero but for rounding."""
    return name.startswith("backbone.encoder.conv_encoder.") and name.endswith(".0.bias")


@pytest.mark.parametrize("case,world,e,microbatch", [("4_ranks", 4, 4, None), ("2_ranks_microbatch_2", 2, 4, 2)],
                         ids=["4_ranks", "2_ranks_microbatch_2"])
def test_sharded_train_step_matches_jax(monkeypatch, case, world, e, microbatch):
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
    seed = 11
    tpu = {"mesh_shape": world} if microbatch is None else {"mesh_shape": world, "episode_microbatch": microbatch}
    d = _step_dict(e, **tpu)
    feat_shape, mdl = GEOMETRIES["small"]
    jexp, jmdl = jcfg.ExperimentConfig.from_dict(d), jcfg.ModelConfig.from_dict(mdl)
    _, variables = jax_variables(jexp, jmdl, feat_shape, seed=seed)
    store = worker.spec_store(feat_shape, seed)
    ep = sample_episode(torch.Generator().manual_seed(seed), store, N_WAY, K_SHOT, K_QUERY, e)
    ep_np = {k: v.numpy() for k, v in vars(ep).items() if v is not None}
    rng = np.random.default_rng(seed)
    draws_s = numpy_draws(rng, e, N_WAY * K_SHOT, *feat_shape, 6)
    draws_q = numpy_draws(rng, e, N_WAY * K_QUERY, *feat_shape, 6)
    views = {"support": jax_views(ep_np["support"], draws_s), "query": jax_views(ep_np["query"], draws_q)}
    loss, grads, new, perms = _jax_sharded_step(jexp, jmdl, variables, ep_np, views, world, microbatch or e, seed=3)

    state = from_jax_variables(variables)
    ranks = _ranks(worker.train_step, world, d, mdl, feat_shape, state, ep_np,
                   {"support": draws_s, "query": draws_q, "perms": perms}, seed)
    got = ranks[0]
    assert sorted(i for r in ranks for i in r["episodes"]) == list(range(e))
    np.testing.assert_allclose(got["metrics"][0], loss, rtol=LOSS_RTOL)
    for r in ranks[1:]:  # replicated: the same averaged gradients and Adam step on every rank
        assert r["metrics"] == got["metrics"]
        for k, v in got["state"].items():
            np.testing.assert_array_equal(r["state"][k], v, err_msg=k)

    want_g = from_jax_variables({"params": grads, "batch_stats": new["batch_stats"]})
    want = from_jax_variables(new)
    unused = {f"projection_head.{ln}.{w}" for ln in ("ln1", "ln2") for w in ("weight", "bias")}
    assert set(got["grads"]) == set(want) - unused - {k for k in want if "running" in k or "tracked" in k}
    for name, g in got["grads"].items():
        wg, got_p, want_p = want_g[name].numpy(), got["state"][name], want[name].numpy()
        if _zero_grad(name):
            ref = np.abs(want_g[name.replace(".bias", ".weight")].numpy()).max()
            assert max(np.abs(g).max(), np.abs(wg).max()) < BN_BIAS_NOISE * ref, name
            np.testing.assert_allclose(got_p, want_p, atol=2 * LR, rtol=0, err_msg=name)
            continue
        grad_rel = CASE_GRAD_REL.get(case, {}).get(name, GRAD_REL)
        np.testing.assert_allclose(g, wg, atol=grad_rel * np.abs(wg).max(), rtol=0, err_msg=name)
        big = np.abs(wg) > grad_rel * np.abs(wg).max()
        np.testing.assert_allclose(got_p[big], want_p[big], atol=PARAM_ATOL, rtol=0, err_msg=name)
        np.testing.assert_allclose(got_p[~big], want_p[~big], atol=2 * LR, rtol=0, err_msg=name)
    for name in want:
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got["state"][name], want[name].numpy(), atol=STATS_ATOL, rtol=0, err_msg=name)


def test_one_rank_mesh_equals_the_plain_trainer():
    """Rank 0 of one seeds and samples as a Trainer outside any group, and
    its one-rank mean of the gradients is the gradient: 3 sampled steps
    (dropout on) give the same parameters, statistics and metrics, to the
    bit."""
    d = _step_dict(1)
    d["n_training_tasks"] = 3
    feat_shape, mdl = GEOMETRIES["fprime"]
    (out,) = _ranks(worker.world_one, 1, d, mdl, feat_shape, 4)
    group, plain = out["group"], out["plain"]
    assert group["has_group"] and not plain["has_group"] and group["step"] == plain["step"] == 3
    assert group["metrics"] == plain["metrics"]
    for k, v in plain["state"].items():
        np.testing.assert_array_equal(group["state"][k], v, err_msg=k)


# (kind, rows per rank, mean, spread, channels)
BN_CASES = {
    "conv_even": ("conv", [2, 2, 2, 2], 0.0, 1.0, 6),
    "conv_uneven": ("conv", [3, 5, 1, 7], 2.0, 3.0, 6),
    "conv_ill_conditioned": ("conv", [3, 5, 1, 7], 2.6, 0.31, 6),
    "head_uneven": ("head", [2, 5, 1, 4], 2.0, 3.0, 8),
    "head_ill_conditioned": ("head", [2, 5, 1, 4], 2.6, 0.31, 8),
}
BN_SEED = 5


@pytest.fixture(scope="module")
def bn_ranks():
    return _ranks(worker.batch_norm, 4, list(BN_CASES.values()), BN_SEED)


@pytest.mark.parametrize("case", list(BN_CASES))
def test_batchnorm_moments_combine_across_ranks(bn_ranks, case):
    kind, counts, mean, spread, c = BN_CASES[case]
    i = list(BN_CASES).index(case)
    rng = np.random.default_rng(BN_SEED)
    shape = (sum(counts), c, 5, 7) if kind == "conv" else (sum(counts), c)
    x = torch.from_numpy((mean + spread * rng.standard_normal(shape)).astype(np.float32)).requires_grad_(True)
    cot = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    bn = worker._seeded_bn(kind, c, BN_SEED)
    assert isinstance(bn, BandwidthBatchNorm if kind == "conv" else HeadBatchNorm) and bn.mesh is None
    y = bn(x)
    y.backward(cot)
    got = [r["cases"][i] for r in bn_ranks]
    y_all = np.concatenate([g["y"] for g in got])
    dx_all = np.concatenate([g["dx"] for g in got])
    np.testing.assert_allclose(y_all, y.detach().numpy(), atol=BN_REL * float(y.detach().abs().max()), rtol=0)
    np.testing.assert_allclose(dx_all, x.grad.numpy(), atol=BN_REL * float(x.grad.abs().max()), rtol=0)
    for name, ref in (("dw", bn.weight.grad), ("db", bn.bias.grad)):
        np.testing.assert_allclose(sum(g[name] for g in got), ref.numpy(), atol=BN_REL * float(ref.abs().max()),
                                   rtol=0, err_msg=name)
    for g in got:  # every rank moves its statistics to the same global moments
        np.testing.assert_allclose(g["running_mean"], bn.running_mean.numpy(), atol=STATS_ATOL, rtol=0)
        np.testing.assert_allclose(g["running_var"], bn.running_var.numpy(), atol=STATS_ATOL, rtol=0)
        assert g["tracked"] == 1


def test_grouped_and_eval_batchnorm_issue_no_collective(bn_ranks):
    """``bn_per_view_group``'s groups lie on one rank and eval applies the
    running statistics: neither reduces across the ranks."""
    assert all(r["grouped_collectives"] == 0 and r["eval_collectives"] == 0 for r in bn_ranks)


EVAL_TASKS, EVAL_S_MAX, EVAL_SEED = 7, 3, 8
EVAL_KEYS = ["single", "multi", "multimin_label", "multimax_posterior"]


def _eval_dict():
    d = exp_dict(use_attention=False, use_contrastive=False, specaug_params={"use": False},
                 test_query_augmentations=False, loss={"l_param": 0.0, "cpl": {"use": False}})
    d["tpu"].update(episode_batch=4, eval_episode_batch=4)  # 7 tasks over 4 ranks: batches of 4 and 3
    return d


@pytest.fixture(scope="module")
def eval_ranks():
    feat_shape, mdl = GEOMETRIES["small"]
    return _ranks(worker.evaluate, 4, _eval_dict(), mdl, feat_shape, EVAL_SEED, EVAL_TASKS, EVAL_S_MAX,
                  ["", "min_label", "max_posterior"])


@pytest.mark.parametrize("key", EVAL_KEYS)
def test_eval_gathers_exactly_the_one_process_accuracies(eval_ranks, key):
    """Every rank returns the 7 accuracies one process gives on the same
    episodes, in order; a rank left without episodes (multi-segment: each
    rank takes up to 4, so ranks 2 and 3 take none) still joins."""
    feat_shape, mdl = GEOMETRIES["small"]
    exp, tmdl = tcfg.ExperimentConfig.from_dict(_eval_dict()), tcfg.ModelConfig.from_dict(mdl)
    multi = key.startswith("multi")
    store = worker.spec_store(feat_shape, EVAL_SEED, s_max=EVAL_S_MAX if multi else 1)
    ref = Trainer(exp, tmdl, store, test_store=store, seed=EVAL_SEED)
    eps = worker.global_episodes(store, EVAL_TASKS, exp.n_way_test, exp.n_shot_test, exp.n_query_test, multi,
                                 EVAL_SEED)
    worker.feed(ref, eps, [EVAL_TASKS])
    want = ref.eval_accuracies(store, EVAL_TASKS, exp.n_way_test, exp.n_shot_test, exp.n_query_test, False,
                               multisegment=multi, tie_strategy=key[len("multi"):] if multi else "")
    assert ref.mesh.group is None and want.shape == (EVAL_TASKS,)
    for r in eval_ranks:
        np.testing.assert_array_equal(r[key]["acc"], want)
    assert [r[key]["eval_batch"] for r in eval_ranks] == ([4] * 4 if multi else [1] * 4)


def test_train_test_cli_on_two_ranks(tmp_path):
    """``cli.train_test`` with ``mesh_shape: 2`` on 2 gloo ranks: 2 epochs
    straight; 1 epoch, then ``--resume`` to 2. Rank 0 alone opens files for
    writing; both ranks train the same epochs with equal metrics and test
    to the same accuracy; the resumed epoch 2 equals the straight one."""
    from audio_few_shot_learning_tpu_torch.data.datasets import make_synthetic_dataset

    make_synthetic_dataset(tmp_path / "synth", n_classes=9, items_per_class=5, n_mels=48, n_frames=64,
                           split_fractions=(3, 3, 3))
    argvs = []
    for name, epochs, root in (("a", 2, "straight"), ("b", 1, "resumed"), ("c", 2, "resumed")):
        d = _step_dict(2, mesh_shape=2)
        d.update(dataset_name="synth", data_root=str(tmp_path), n_testing_tasks=3, num_epochs=epochs,
                 experiment_folder="run", n_way_test=N_WAY, patience=5)
        d["tpu"]["num_runs"] = 1
        (tmp_path / f"{name}.json").write_text(json.dumps(d))
        argvs.append(["-e", str(tmp_path / f"{name}.json"), "-m", str(tmp_path / "mdl.json"),
                      "--experiments-root", str(tmp_path / root)] + (["--resume"] if name == "c" else []))
    (tmp_path / "mdl.json").write_text(json.dumps(GEOMETRIES["fprime"][1]))
    ranks = _ranks(worker.cli_runs, 2, argvs, str(tmp_path))
    r0, r1 = ranks
    for run in r1["runs"]:
        assert run["writes"] == []
    files = {"config.json", "model.ckpt", "result_run0.json", "metrics_run0.jsonl", "resume_run0.ckpt",
             "resume_run0.ckpt.meta.json"}
    assert {os.path.basename(w).replace(".tmp", "") for w in r0["runs"][0]["writes"]} == files
    for root in ("straight", "resumed"):
        assert {p.name for p in (tmp_path / root / "run").iterdir()} == files
    timed = ("episodes_per_sec", "step_ms")  # each rank's own clock
    for a, b in zip(r0["runs"], r1["runs"]):  # the same epochs, the same metrics: they stopped together
        assert [{k: v for k, v in h.items() if k not in timed} for h in a["history"]] == \
            [{k: v for k, v in h.items() if k not in timed} for h in b["history"]]
        assert a["results"][0]["mean_accuracy"] == b["results"][0]["mean_accuracy"]
    straight, resumed = r0["runs"][0]["history"], r0["runs"][2]["history"]
    assert [h["epoch"] for h in straight] == [1, 2] and [h["epoch"] for h in resumed] == [2]
    for key in ("loss", "fsl_loss", "cpl_loss", "val_accuracy"):
        assert resumed[0][key] == straight[1][key], key
    a = torch.load(tmp_path / "straight" / "run" / "resume_run0.ckpt", weights_only=True)
    b = torch.load(tmp_path / "resumed" / "run" / "resume_run0.ckpt", weights_only=True)
    assert a["generator"].shape[0] == 2 and torch.equal(a["generator"], b["generator"])
    torch.testing.assert_close(b["model"], a["model"], atol=0, rtol=0)


def test_initialize_is_a_no_op_without_a_launch(monkeypatch):
    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    assert maybe_initialize_distributed() is False
    assert not torch.distributed.is_initialized()


def test_mesh_shape_needs_a_process_group():
    """Outside a group a mesh of more than one rank raises and names
    torchrun, in ``make_mesh`` and in the Trainer; nothing runs it on one
    device instead. One rank is this process alone."""
    with pytest.raises(RuntimeError, match="torchrun"):
        make_mesh(2, "cpu")
    feat_shape, mdl = GEOMETRIES["fprime"]
    texp = tcfg.ExperimentConfig.from_dict(_step_dict(2, mesh_shape=2))
    with pytest.raises(RuntimeError, match="torchrun"):
        Trainer(texp, tcfg.ModelConfig.from_dict(mdl), worker.spec_store(feat_shape, 0))
    one = make_mesh(1, "cpu")
    assert (one.rank, one.world, one.group) == (0, 1, None)


def test_episode_shares():
    """Even and uneven shares, chunk by chunk, and the eval batches' fill."""
    from audio_few_shot_learning_tpu_torch.train.engine import fill_shares

    meshes = [EpisodeMesh(r, 4, torch.device("cpu")) for r in range(4)]
    assert meshes[0].shares(7) == [2, 2, 2, 1] and meshes[0].shares(2) == [1, 1, 0, 0]
    assert [m.episode_shard(7) for m in meshes] == [slice(0, 2), slice(2, 4), slice(4, 6), slice(6, 7)]
    assert [m.chunk_shard(8, 4) for m in meshes] == [[0, 4], [1, 5], [2, 6], [3, 7]]
    assert fill_shares(3, [1, 1, 1, 1]) == [1, 1, 1, 0] and fill_shares(7, [4, 4, 4, 4]) == [4, 3, 0, 0]


def test_parallel_modules_are_in_the_import_scan():
    """``parallel/`` is scanned by the port's import rule
    (tests/test_torch_port_slice.py) and, like the ranks' worker module,
    imports nothing of JAX."""
    from test_torch_port_slice import FORBIDDEN, PORT

    scanned = set(PORT.rglob("*.py"))
    parallel = sorted((PORT / "parallel").glob("*.py"))
    assert {p.name for p in parallel} >= {"__init__.py", "mesh.py", "spawn.py", "dryrun.py"}
    assert set(parallel) <= scanned
    for path in parallel + [REPO / "tests" / "_torch_port_parallel_worker.py"]:
        for node in ast.walk(ast.parse(path.read_text())):
            names = [a.name for a in node.names] if isinstance(node, ast.Import) else (
                [node.module] if isinstance(node, ast.ImportFrom) and node.module else [])
            assert not [n for n in names if n.split(".")[0] in FORBIDDEN], (path, names)


def test_dryrun_multichip_on_cpu_ranks():
    """The dry run on 2 gloo ranks at the small geometry: its three checks
    pass (it raises otherwise), and on the CPU no kernel launches."""
    out = dryrun.dryrun_multichip(2, threads=1, timeout_s=SPAWN_TIMEOUT_S)
    assert out["ranks"] == 2 and out["steps"] == dryrun.STEPS and len(out["losses"]) == dryrun.STEPS
    assert out["loss_rel"] <= dryrun.LOSS_RTOL and out["grad_worst_rel_of_scale"] <= dryrun.GRAD_REL["small"]
    assert out["launches_per_step"] == [[[0, 0, 0]] * dryrun.STEPS] * 2
    assert 0.0 <= out["eval_accuracy"] <= 1.0 and np.isfinite(out["epoch"]["loss"])
