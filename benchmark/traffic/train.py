"""Training traffic: a closed loop of optimizer steps as ``Trainer.train_epoch``
takes them: each unit samples its episodes with the program's sampler
(``sample_episode``) and draws its SpecAugment views, view shuffle and CPL
noise with the program's own draws, from a generator of the seed, then
calls ``Trainer.train_step`` with them. The dropout masks the program draws
from the generator the benchmark handed it.

Set-up drives the trainer through its first ``check_steps`` steps by the
window's own call, keeps their episodes and draws, reads their losses, each
leaf's first gradient (from Adam's first moment after one step) and each
leaf's change over the steps, warms up, and hands the same trainer to the
window. The check follows those steps with the plain reference.

Mix parameters: ``check_steps``, ``warm_units``, ``trace_units``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import data, harness, program, roofline
from benchmark.reference import compare, episodes
from benchmark.reference import model as ref


class State:
    pass


def setup(run) -> State:
    s = State()
    s.run = run
    exp = run.config["experiment"]
    s.n, s.ks, s.kq = exp["n_way_train"], exp["n_shot_train"], exp["n_query_train"]
    s.trainer, s.store = program.build(run, data.make_split(run.config["dataset"], run.seed, run.device))
    s.feed = data.generator(run.seed, program.FEED_STREAM, run.device)
    s.episodes = s.trainer.episode_batch
    s.metrics, s.marks, s.kept = {}, {}, {}
    s.failed_units = set()
    s.weights0 = {k: v.detach().clone() for k, v in s.trainer.model.named_parameters()}
    run.plant("trainer", s.trainer)
    s.check_steps = int(run.mix["check_steps"])
    for i in range(s.check_steps):
        unit(s, i)
        if i == 0:
            beta1 = s.trainer.optimizer.param_groups[0]["betas"][0]
            state = s.trainer.optimizer.state
            s.prog_grads = {k: float(state[p]["exp_avg"].double().norm()) / (1.0 - beta1)
                            for k, p in s.trainer.model.named_parameters() if p in state and "exp_avg" in state[p]}
    s.prog_change = {k: float((p.detach() - s.weights0[k]).double().norm())
                     for k, p in s.trainer.model.named_parameters()}
    s.prog = dict(losses=[float(s.metrics[i][0]) for i in range(s.check_steps)], grads=s.prog_grads,
                  change=s.prog_change)
    s.next = s.check_steps
    return s


def unit(s: State, i: int) -> None:
    ep, draws = program.train_feed(s.trainer, s.store, s.feed, s.episodes)
    if i < s.check_steps:
        s.kept[i] = (ep, draws)
    if s.run.cuda:
        mark = torch.cuda.Event(enable_timing=True)
        mark.record()
        s.marks[i] = mark
    try:
        s.metrics[i] = s.trainer.train_step(ep, draws)
    except torch.cuda.OutOfMemoryError:
        s.failed_units.add(i)


def window(s: State, seconds: float) -> dict:
    w = harness.throughput_window(lambda i: unit(s, i), seconds, s.run.device, first=s.next)
    s.next = w["first"] + w["units"]
    if s.run.cuda:  # a mark after the last step closes its interval
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        s.marks[s.next] = end
    return w


def finish(s: State, w: dict) -> dict:
    harness.sync(s.run.device)
    done = range(w["first"], w["first"] + w["units"])
    ok = [i for i in done if i in s.metrics]
    if ok:
        finite = torch.isfinite(torch.stack([s.metrics[i] for i in ok])).all(dim=-1).tolist()
        bad = {i for i, f in zip(ok, finite) if not f}
    else:
        bad = set()
    failed = len(bad | (s.failed_units & set(done)))
    s.step_ms = [s.marks[i].elapsed_time(s.marks[i + 1]) for i in done if i in s.marks and i + 1 in s.marks]
    rate = (w["units"] - failed) * s.episodes / w["seconds"]
    return dict(attempted=w["units"] * s.episodes, failed=failed * s.episodes,
                metrics={"train_episodes_per_s": rate})


def describe(s: State) -> dict:
    cfg = s.run.config
    f, t = cfg["dataset"]["feat_shape"]
    v = program.views(cfg)
    return dict(
        episodes_per_unit=s.episodes,
        flops_per_episode=roofline.train_step_flops(cfg["model"], (f, t), v, s.n * s.ks, s.n * s.kq, s.n),
        peak_flops=roofline.PEAK_BF16_FLOPS,
        unit_ms=s.step_ms,
        # K1 runs on the float32 rows, once for the support and once for the queries
        launches={"views_kernel": [roofline.k1_bytes(s.episodes, s.n * s.ks, f, t),
                                   roofline.k1_bytes(s.episodes, s.n * s.kq, f, t)]},
    )


def check(s: State) -> dict:
    """Free the program; follow its first steps with the reference."""
    run = s.run
    kept = [s.kept[i] for i in range(s.check_steps)]
    steps_per_epoch = s.trainer.steps_per_epoch
    s.trainer = s.store = s.metrics = s.marks = s.kept = None
    if run.cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    numbers = reference_numbers(run, kept, steps_per_epoch, "float32")
    s.check_seconds = time.perf_counter() - t0
    out = numbers_vs(s.prog, numbers, run.limits["limits"])
    harness.note(f"readings not compared: {out.pop('readings')}")
    return out


def reference_episodes(run, kept: list):
    """The reference's own episodes for the program's kept steps, from the
    raw split, and the faults of the program's episodes and draws."""
    exp = run.config["experiment"]
    n, ks, kq = exp["n_way_train"], exp["n_shot_train"], exp["n_query_train"]
    f, t = run.config["dataset"]["feat_shape"]
    split = data.make_split(run.config["dataset"], run.seed, run.device)
    index = episodes.SplitIndex(split, kept[0][0].support.dtype)
    out, faults = [], 0
    for ep, draws in kept:
        ep = program.as_dict(ep)
        bad, sup_g, qry_g = episodes.judge_episodes(index, ep, n, ks, kq)
        faults += bad + episodes.perm_faults(draws.perms, program.views(run.config))
        for d in (draws.support, draws.query):
            faults += episodes.draw_faults(d, exp["specaug_params"], f, t)
        out.append(dict(support=episodes.gather(split, sup_g), query=episodes.gather(split, qry_g),
                        support_labels=ep["support_labels"], query_labels=ep["query_labels"],
                        sup_draws=draws.support, qry_draws=draws.query, perms=draws.perms, gumbel=draws.cpl_gumbel))
    return out, faults


def reference_numbers(run, kept: list, steps_per_epoch: int, precision: str, mutate=None) -> dict:
    cfg = run.config
    eps, faults = reference_episodes(run, kept)
    w = program.weights(cfg, run.seed, run.device)
    r = ref.train_steps(eps, w, cfg["experiment"], cfg["model"], data.sub_seed(run.seed, program.DROPOUT_STREAM),
                        steps_per_epoch, precision, mutate)
    return {**r, "episode_faults": faults}


def readings(r: dict) -> dict:
    """A reference run's readings in the program's form: losses, and the
    norm of each leaf's first gradient and of its change."""
    return dict(losses=r["losses"], grads=compare.norms(r["first_grads"]), change=compare.norms(r["change"]))


def numbers_vs(prog: dict, r: dict, limits: dict) -> dict:
    """The numbers of readings ``prog`` against the reference's ``r``, over
    the leaves the reference moves: the faults of the program's episodes
    and draws, the median and the worst leaf's gap of first-gradient norms,
    the median leaf's gap of change norms (compared), and the worst leaf's
    change gap and the worst step's relative loss gap (``readings`` only:
    see ``PERF.md``)."""
    ref_read = readings(r)
    leaves = compare.moving_leaves(ref_read["grads"])
    grads = compare.leaf_gaps(prog["grads"], ref_read["grads"], leaves)
    change = compare.leaf_gaps(prog["change"], ref_read["change"], leaves)
    return {
        "episode_faults": dict(value=r.get("episode_faults", 0), limit=0),
        "grad_gap_median": dict(value=float(np.median(list(grads.values()))), limit=limits["grad_gap_median"]),
        "grad_gap_worst": dict(value=max(grads.values()), limit=limits["grad_gap_worst"]),
        "change_gap_median": dict(value=float(np.median(list(change.values()))), limit=limits["change_gap_median"]),
        "readings": dict(
            loss_gap=max(abs(p - q) / abs(q) for p, q in zip(prog["losses"], ref_read["losses"])),
            grad_worst_leaf=max(grads, key=grads.get),
            change_gap_worst=max(change.values()), change_worst_leaf=max(change, key=change.get)),
    }
