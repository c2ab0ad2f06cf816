"""What each rank of tests/test_torch_port_parallel.py runs.

Every function here runs inside a rank that ``parallel/spawn.py::run_ranks``
started, in an initialised gloo process group on the CPU. This module
imports torch, numpy and the port only: the ranks never import JAX.
"""

from __future__ import annotations

import builtins
import os

import numpy as np
import torch
import torch.distributed as dist

from audio_few_shot_learning_tpu_torch.config import ExperimentConfig, ModelConfig
from audio_few_shot_learning_tpu_torch.data.episodes import EpisodeBatch, sample_episode
from audio_few_shot_learning_tpu_torch.data.store import PackedStore
from audio_few_shot_learning_tpu_torch.models.dropout import Dropout
from audio_few_shot_learning_tpu_torch.models.encoders import BandwidthBatchNorm, HeadBatchNorm
from audio_few_shot_learning_tpu_torch.parallel.mesh import EpisodeMesh, make_mesh
from audio_few_shot_learning_tpu_torch.train.engine import TrainDraws, Trainer, _slice_tree, fill_shares


def no_dropout(model) -> None:
    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0


def spec_store(feat_shape, seed, n_classes=5, per_class=5, s_max=1) -> PackedStore:
    """Seeded noise items; with ``s_max`` > 1, of 1..s_max segments (item 0
    has s_max)."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(1, s_max + 1, n_classes * per_class)
    counts[0] = s_max
    segments = rng.standard_normal((int(counts.sum()),) + tuple(feat_shape)).astype(np.float32)
    return PackedStore.from_flat_arrays(segments, counts, np.repeat(np.arange(n_classes), per_class),
                                        n_classes, device="cpu")


def train_step(exp_dict, mdl_dict, feat_shape, state_dict, ep, draws, seed):
    """One train step of this rank's share of the global batch ``ep`` (numpy
    arrays) with the spec-augment draws and view permutations ``draws``,
    every dropout at p = 0. Returns the metrics, gradients, parameters and
    running statistics after the step."""
    exp = ExperimentConfig.from_dict(exp_dict)
    store = spec_store(feat_shape, seed)
    trainer = Trainer(exp, ModelConfig.from_dict(mdl_dict), store, seed=seed)
    trainer.model.load_state_dict(state_dict, strict=True)
    no_dropout(trainer.model)
    mesh, e = trainer.mesh, exp.tpu.episode_batch
    mine = mesh.chunk_shard(e, exp.tpu.episode_microbatch or e)
    t = {k: torch.from_numpy(v) for k, v in ep.items()}
    local = _slice_tree(EpisodeBatch(**t), mine)
    d = {k: tuple(torch.from_numpy(x) for x in v) if isinstance(v, tuple) else torch.from_numpy(v)
         for k, v in draws.items()}
    metrics = trainer.train_step(local, _slice_tree(TrainDraws(**d), mine))
    return dict(
        rank=mesh.rank, episodes=mine, metrics=metrics.tolist(),
        grads={n: p.grad.numpy().copy() for n, p in trainer.model.named_parameters() if p.grad is not None},
        state={k: v.numpy().copy() for k, v in trainer.model.state_dict().items()},
    )


def world_one(exp_dict, mdl_dict, feat_shape, seed):
    """Three sampled steps (dropout on) of a one-rank mesh in a gloo group
    and of a Trainer outside any group, from one seed: both state dicts
    and both epochs' metrics."""
    exp, mdl = ExperimentConfig.from_dict(exp_dict), ModelConfig.from_dict(mdl_dict)
    out = {}
    for name, mesh in (("group", make_mesh(1, "cpu")), ("plain", EpisodeMesh(0, 1, torch.device("cpu")))):
        store = spec_store(feat_shape, seed)
        trainer = Trainer(exp, mdl, store, seed=seed, mesh=mesh)
        metrics = trainer.train_epoch()
        out[name] = dict(metrics={k: v for k, v in metrics.items() if k != "episodes_per_sec"},
                         state={k: v.numpy().copy() for k, v in trainer.model.state_dict().items()},
                         has_group=trainer.mesh.group is not None, step=trainer.step)
    return out


def batch_norm(cases, seed):
    """For each case (kind, per-rank row counts, mean, spread, channels):
    this rank's rows of a seeded global batch through a train-mode
    BatchNorm on the mesh, backward from a seeded global cotangent. Returns
    per case this rank's output and input gradient, the affine's gradient
    (this rank's part) and the running statistics. Then the grouped path
    and eval mode with the mesh set, counting the collectives they issue."""
    mesh = make_mesh(device="cpu")
    out = []
    for kind, counts, mean, spread, c in cases:
        rng = np.random.default_rng(seed)
        shape = (sum(counts), c, 5, 7) if kind == "conv" else (sum(counts), c)
        x = (mean + spread * rng.standard_normal(shape)).astype(np.float32)
        cot = rng.standard_normal(shape).astype(np.float32)
        lo = sum(counts[: mesh.rank])
        bn = _seeded_bn(kind, c, seed)
        bn.mesh = mesh
        xs = torch.from_numpy(x[lo : lo + counts[mesh.rank]]).requires_grad_(True)
        y = bn(xs)
        y.backward(torch.from_numpy(cot[lo : lo + counts[mesh.rank]]))
        out.append(dict(y=y.detach().numpy(), dx=xs.grad.numpy(), dw=bn.weight.grad.numpy(),
                        db=bn.bias.grad.numpy(), running_mean=bn.running_mean.numpy(),
                        running_var=bn.running_var.numpy(), tracked=int(bn.num_batches_tracked)))
    calls = []
    real = dist.all_reduce

    def counted(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    dist.all_reduce = counted
    try:
        bn = _seeded_bn("conv", 4, seed)
        bn.mesh = mesh
        x = torch.randn((2 * (3 * 2 + 2 * 2), 4, 5, 7), requires_grad=True)  # E=2 of (S, Vs, Q, Vq) = (3, 2, 2, 2)
        bn(x, view_groups=(3, 2, 2, 2)).sum().backward()
        grouped = len(calls)
        bn.eval()
        with torch.no_grad():
            bn(x)
        evaluated = len(calls) - grouped
    finally:
        dist.all_reduce = real
    return dict(cases=out, grouped_collectives=grouped, eval_collectives=evaluated)


def _seeded_bn(kind, c, seed):
    rng = np.random.default_rng(seed + 1)
    bn = BandwidthBatchNorm(c) if kind == "conv" else HeadBatchNorm(c)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)))
        bn.bias.copy_(torch.from_numpy(rng.uniform(-0.1, 0.1, c).astype(np.float32)))
        bn.running_mean.copy_(torch.from_numpy((0.1 * rng.standard_normal(c)).astype(np.float32)))
        bn.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, c).astype(np.float32)))
    return bn.train()


def global_episodes(store, n_tasks, n_way, k_shot, k_query, is_test, seed):
    """``n_tasks`` episodes drawn once from a seeded generator: the same in
    every rank and in one process."""
    return sample_episode(torch.Generator().manual_seed(seed), store, n_way, k_shot, k_query, n_tasks,
                          is_test=is_test)


def feed(trainer, episodes, caps_of_rank):
    """Replace ``trainer``'s batch source by this rank's shares of
    ``episodes``, batch after batch as ``eval_accuracies`` spreads them
    (``fill_shares`` over the ranks' ``caps_of_rank``)."""
    mesh, n = trainer.mesh, episodes.support.shape[0]
    order, done = [], 0
    while done < n:
        shares = fill_shares(n - done, caps_of_rank)
        lo = done + sum(shares[: mesh.rank])
        order.extend(range(lo, lo + shares[mesh.rank]))
        done += sum(shares)
    cursor = [0]

    def take(size):
        sl = order[cursor[0] : cursor[0] + size]
        cursor[0] += size
        return _slice_tree(episodes, sl)

    trainer._batches = lambda *args, **kwargs: take


def evaluate(exp_dict, mdl_dict, feat_shape, seed, n_tasks, s_max, ties):
    """Eval of ``n_tasks`` fixed episodes split over the mesh: single
    segment, then multi-segment under each tie strategy in ``ties``. Returns
    the gathered accuracies of each and this rank's eval batch."""
    exp, mdl = ExperimentConfig.from_dict(exp_dict), ModelConfig.from_dict(mdl_dict)
    out = {}
    for name, store_smax, is_test in (("single", 1, False), ("multi", s_max, True)):
        store = spec_store(feat_shape, seed, s_max=store_smax)
        trainer = Trainer(exp, mdl, store, test_store=store, seed=seed)
        eps = global_episodes(store, n_tasks, exp.n_way_test, exp.n_shot_test, exp.n_query_test, is_test, seed)
        for tie in ties if is_test else ("",):
            batch = trainer.eval_batch_size(store, n_tasks, exp.n_way_test, exp.n_shot_test, exp.n_query_test,
                                            False, is_test)
            caps = trainer.mesh.shares(batch) if not is_test else [batch] * trainer.mesh.world
            feed(trainer, eps, caps)
            acc = trainer.eval_accuracies(store, n_tasks, exp.n_way_test, exp.n_shot_test, exp.n_query_test,
                                          False, multisegment=is_test, tie_strategy=tie)
            out[f"{name}{tie}"] = dict(acc=acc, eval_batch=trainer.last_eval_batch)
    return out


def cli_runs(runs, audit_root):
    """``cli.train_test.main`` on each argv of ``runs`` in turn; records
    every file this rank opens for writing (``open``, ``torch.save``) under
    ``audit_root``. Returns per run the results and the epochs trained."""
    from audio_few_shot_learning_tpu_torch.cli import train_test
    from audio_few_shot_learning_tpu_torch.train import experiment

    writes, histories = [], []
    real_open, real_save, real_run = builtins.open, torch.save, experiment.run_single_training

    def record(file):
        if os.path.abspath(str(file)).startswith(audit_root):
            writes.append(os.path.relpath(str(file), audit_root))

    def audited(file, mode="r", *args, **kwargs):
        if any(m in mode for m in "wax+"):
            record(file)
        return real_open(file, mode, *args, **kwargs)

    def saved(obj, f, *args, **kwargs):
        record(f)
        return real_save(obj, f, *args, **kwargs)

    def recorded(*args, **kwargs):
        log = real_run(*args, **kwargs)
        histories.append(log["history"])
        return log

    builtins.open, torch.save, experiment.run_single_training = audited, saved, recorded
    out = []
    try:
        for argv in runs:
            writes.clear()
            histories.clear()
            results = train_test.main(argv)
            out.append(dict(results=results, writes=sorted(set(writes)), history=list(histories[0])))
    finally:
        builtins.open, torch.save, experiment.run_single_training = real_open, real_save, real_run
    return dict(rank=dist.get_rank(), runs=out)
