"""Test traffic: consecutive eval batches as ``Trainer.eval_accuracies``
takes them: each unit samples its batch with the program's sampler
(``sample_episode``; a multi-segment split's queries carry every segment,
padded to ``s_max``) and draws its SpecAugment views with the program's own
draw, from a generator of the seed, then calls the program's per-batch eval
(``Trainer._eval_episodes``, the body of ``eval_accuracies``'s loop, which
takes no draws of its own) in eval mode under ``torch.inference_mode``, at
the batch size the engine reckons (``Trainer.eval_batch_size``:
``eval_episode_batch``, or for a multi-segment split what the card's free
memory holds). Multi-segment queries are scored by the majority vote under
the configuration's tie strategy.

A seeded sample of ``check_units`` batches of the window keeps its
episodes, draws, scores and accuracies; after the window the reference
judges the episodes, scores the same rows of its own split with the same
draws, and the vote is taken again from the program's scores.

Mix parameters: ``warm_units``, ``trace_units``.
"""

from __future__ import annotations

import time

import torch

from benchmark import data, harness, program, roofline
from benchmark.reference import compare, episodes
from benchmark.reference import model as ref

SAMPLE_STREAM = 6


class State:
    pass


def _params(run):
    exp = run.config["experiment"]
    return exp["n_way_test"], exp["n_shot_test"], exp["n_query_test"]


def setup(run) -> State:
    s = State()
    s.run = run
    exp = run.config["experiment"]
    s.n, s.ks, s.kq = _params(run)
    s.augment = exp["test_query_augmentations"]
    s.multiseg = bool(exp["multi_segm"])
    s.tie = exp["tie_strategy"]
    s.trainer, s.store = program.build(run, data.make_split(run.config["dataset"], run.seed, run.device))
    s.s_max = s.store.s_max if s.multiseg else 1
    s.feed = data.generator(run.seed, program.FEED_STREAM, run.device)
    # the batch size the engine reckons at test time, from what is free once the split is loaded
    s.episodes = s.trainer.eval_batch_size(s.store, 10**9, s.n, s.ks, s.kq, s.augment, s.multiseg)
    s.trainer.model.eval()
    s.accs, s.finite, s.failed_units = {}, {}, set()
    s.sample = harness.Reservoir(int(run.limits["check_units"]), data.sub_seed(run.seed, SAMPLE_STREAM))
    s.kept = {}
    s.scores = None
    s.trainer.model.register_forward_hook(lambda mod, args, out: setattr(s, "scores", out.scores))
    run.plant("trainer", s.trainer)
    s.next = 0
    s.in_window = False
    return s


def unit(s: State, i: int) -> None:
    ep, draws = program.eval_feed(s.trainer, s.store, s.feed, s.episodes, s.n, s.ks, s.kq, s.augment, s.multiseg)
    slot = s.sample.take() if s.in_window else -1
    try:
        with torch.inference_mode():
            acc = s.trainer._eval_episodes(ep, s.n, s.augment, draws=draws, store=s.store, multisegment=s.multiseg,
                                           tie_strategy=s.tie, s_max=s.s_max)
        s.accs[i] = acc
        s.finite[i] = torch.isfinite(s.scores).all()
        if slot >= 0:
            s.kept[slot] = (i, program.as_dict(ep), draws, s.scores.clone(), acc)
    except torch.cuda.OutOfMemoryError:
        s.failed_units.add(i)
    s.scores = None


def window(s: State, seconds: float) -> dict:
    s.in_window = True
    w = harness.throughput_window(lambda i: unit(s, i), seconds, s.run.device, first=s.next)
    s.in_window = False
    s.next = w["first"] + w["units"]
    return w


def finish(s: State, w: dict) -> dict:
    harness.sync(s.run.device)
    done = list(range(w["first"], w["first"] + w["units"]))
    ok = [i for i in done if i in s.accs]
    finite = torch.stack([s.finite[i] for i in ok]).tolist() if ok else []
    failed = len(s.failed_units & set(done)) + sum(1 for f in finite if not f)
    if ok:
        torch.cat([s.accs[i] for i in ok]).cpu()  # every accuracy of the window read back
    rate = (w["units"] - failed) * s.episodes / w["seconds"]
    return dict(attempted=w["units"] * s.episodes, failed=failed * s.episodes,
                metrics={"test_episodes_per_s": rate})


def describe(s: State) -> dict:
    cfg = s.run.config
    f, t = cfg["dataset"]["feat_shape"]
    v = program.views(cfg)
    e, sup, rows = s.episodes, s.n * s.ks, s.n * s.kq * s.s_max
    d = v * cfg["model"]["Attention"]["embed_dim"]
    return dict(
        episodes_per_unit=e,
        eval_batch=e,
        flops_per_episode=roofline.eval_forward_flops(cfg["model"], (f, t), v, sup, rows, s.n),
        peak_flops=roofline.PEAK_BF16_FLOPS,
        launches={"views_kernel": [roofline.k1_bytes(e, sup, f, t), roofline.k1_bytes(e, rows, f, t)],
                  "episode_scores_kernel": [roofline.k2_cost(e, sup, rows, d, s.n)]},
    )


def check(s: State) -> dict:
    """Free the program; score the kept batches with the reference."""
    run = s.run
    kept = sorted(s.kept.values(), key=lambda x: x[0])
    inputs = [(ep, draws) for _, ep, draws, _, _ in kept]
    prog = [(sc, acc.cpu().numpy()) for _, _, _, sc, acc in kept]
    s.trainer = s.store = s.accs = s.finite = s.kept = None
    if run.cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    refs, faults = reference_scores(run, inputs, "float32")
    s.check_seconds = time.perf_counter() - t0
    return {"episode_faults": dict(value=faults, limit=0), **numbers_vs(s, prog, refs)}


def reference_scores(run, inputs: list, precision: str):
    """The reference's scores ``[E, Qtot, N]`` of each kept batch, the mask
    of its real query rows, ``s_max`` and the rows' labels, from the rows of its own split
    that the program's episodes name; and the faults of those episodes and
    of their draws."""
    cfg = run.config
    exp = cfg["experiment"]
    n, ks, kq = _params(run)
    f, t = cfg["dataset"]["feat_shape"]
    split = data.make_split(cfg["dataset"], run.seed, run.device)
    w = program.weights(cfg, run.seed, run.device)
    s_max = int(split["counts"].max()) if exp["multi_segm"] else 1
    mv = float(exp["specaug_params"]["mask_value"])
    out, faults = [], 0
    if not inputs:
        return out, faults
    index = episodes.SplitIndex(split, inputs[0][0]["support"].dtype)
    with torch.no_grad():
        for ep, (sup_draws, qry_draws) in inputs:
            bad, sup_g, qry_g = episodes.judge_episodes(index, ep, n, ks, kq, s_max)
            faults += bad + sum(episodes.draw_faults(d, exp["specaug_params"], f, t) for d in (sup_draws, qry_draws))
            sup, qry = episodes.gather(split, sup_g), episodes.gather(split, qry_g)
            real = qry_g >= 0
            sv = ref.views(sup, *sup_draws, mv)
            qv = ref.views(qry, *qry_draws, mv) if exp["test_query_augmentations"] else qry[:, :, None]
            out.append((ref.eval_scores(sv, qv, ep["support_labels"], n, w, cfg["model"], precision), real, s_max,
                        ep["query_labels"]))
    return out, faults


def numbers_vs(s: State, prog: list, refs: list) -> dict:
    """Scores against the reference's, and the accuracies the program read
    against the plain vote (or argmax) on the program's own scores."""
    n, _, kq = _params(s.run)
    lim = s.run.limits["limits"]
    err, gap, mismatched = 0.0, 0.0, 0
    for (p_scores, p_acc), (r_scores, real, s_max, q_labels) in zip(prog, refs):
        nums = compare.score_numbers(p_scores.reshape(-1, n), r_scores.reshape(-1, n), real.reshape(-1))
        err, gap = max(err, nums["score_err"]), max(gap, nums["argmax_gap"])
        if p_scores.shape != r_scores.shape:  # rows missing: every episode's accuracy is unfounded
            mismatched += p_scores.shape[0]
            continue
        sc = p_scores.float().cpu().numpy()
        rl, labels = real.cpu().numpy(), q_labels.cpu().numpy()
        for j in range(sc.shape[0]):
            acc = compare.vote_accuracy(sc[j], rl[j], labels[j], s_max, s.tie)
            mismatched += int(abs(float(p_acc[j]) - acc) > 0.5 / (n * kq))  # a different count of right votes
    return {
        "score_err": dict(value=err, limit=lim["score_err"]),
        "argmax_gap": dict(value=gap, limit=lim["argmax_gap"]),
        "accuracy_mismatches": dict(value=mismatched, limit=0),
    }
