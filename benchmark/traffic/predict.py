"""Predict traffic: one caller in a closed loop, each request a fixed
episode classified by the program's serving entry, ``Trainer.predict_episode``
(``cli/predict.py``'s call): support and query clips the caller picked from
the seeded split, as float32 numpy in host memory (a pool of ``pool_units``
requests, cycled). Each request draws its SpecAugment views with the
program's own draw, as ``predict_episode`` does from the generator
``cli/predict.py`` hands it, from a generator of the seed, and hands them
in as ``draws``. A request's latency is the host clock from the draws to
the returned numpy arrays.

A seeded sample of ``check_units`` requests keeps its scores and draws;
after the window the reference scores the same clips with the same draws.

Mix parameters: ``pool_units``, ``warm_units``, ``trace_units``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import data, harness, program
from benchmark.reference import compare, episodes
from benchmark.reference import model as ref

REQUEST_STREAM, SAMPLE_STREAM = 7, 6


class State:
    pass


def _params(run):
    exp = run.config["experiment"]
    return exp["n_way_test"], exp["n_shot_test"], exp["n_query_test"]


def requests(dataset: dict, counts: np.ndarray, units: int, n: int, ks: int, kq: int, seed: int):
    """The caller's clips of each request: split rows of the support
    ``[U, n*ks]`` and the queries ``[U, n*kq]``, class-major, of ``n``
    classes of the split and one segment of each of ``ks + kq`` items a class."""
    rng = np.random.default_rng(data.sub_seed(seed, REQUEST_STREAM))
    classes, per = dataset["classes"], dataset["items_per_class"]
    offsets = np.cumsum(counts) - counts
    sup, qry = [], []
    for _ in range(units):
        items = [c * per + rng.permutation(per)[: ks + kq] for c in np.sort(rng.permutation(classes)[:n])]
        rows = [offsets[it] + rng.integers(0, counts[it]) for it in items]
        sup.append(np.concatenate([r[:ks] for r in rows]))
        qry.append(np.concatenate([r[ks:] for r in rows]))
    return np.stack(sup), np.stack(qry)


def setup(run) -> State:
    s = State()
    s.run = run
    ds = run.config["dataset"]
    s.n, s.ks, s.kq = _params(run)
    split = data.make_split(ds, run.seed, run.device)
    s.host = split["segments"].cpu().numpy()  # the caller's clips, in host memory
    s.trainer, _ = program.build(run, split)
    s.units = int(run.mix["pool_units"])
    counts = split["counts"].cpu().numpy()
    s.sup_rows, s.qry_rows = requests(ds, counts, s.units, s.n, s.ks, s.kq, run.seed)
    s.labels = np.repeat(np.arange(s.n), s.ks)
    s.feed = data.generator(run.seed, program.FEED_STREAM, run.device)
    s.sample = harness.Reservoir(int(run.limits["check_units"]), data.sub_seed(run.seed, SAMPLE_STREAM))
    s.kept, s.failed_units = {}, set()
    s.in_window = False
    run.plant("trainer", s.trainer)
    s.next = 0
    return s


def unit(s: State, i: int) -> float:
    k = i % s.units
    sup = s.host[s.sup_rows[k]]
    qry = s.host[s.qry_rows[k]]
    slot = s.sample.take() if s.in_window else -1
    t0 = time.perf_counter()
    try:
        draws = (program.feed_views(s.trainer, s.feed, 1, len(sup)),
                 program.feed_views(s.trainer, s.feed, 1, len(qry), s.trainer.exp.test_query_augmentations))
        pred, scores = s.trainer.predict_episode(sup, s.labels, qry, n_way=s.n, draws=draws)
    except torch.cuda.OutOfMemoryError:
        s.failed_units.add(i)
        return time.perf_counter() - t0
    lat = time.perf_counter() - t0
    if not np.isfinite(scores).all():
        s.failed_units.add(i)
    if slot >= 0:
        s.kept[slot] = (i, k, scores, draws)
    return lat


def window(s: State, seconds: float) -> dict:
    s.in_window = True
    w = harness.latency_window(lambda i: unit(s, i), seconds, first=s.next)
    s.in_window = False
    s.next = w["first"] + w["units"]
    return w


def finish(s: State, w: dict) -> dict:
    done = set(range(w["first"], w["first"] + w["units"]))
    failed = len(s.failed_units & done)
    ms = [1e3 * x for x in w["latencies"]]
    s.window_ms = ms
    return dict(attempted=w["units"], failed=failed, metrics={"predict_ms_p95": harness.percentile(ms, 95)})


def describe(s: State) -> dict:
    return dict(episodes_per_unit=1, unit_ms=s.window_ms)


def check(s: State) -> dict:
    """Free the program; score the kept requests with the reference."""
    run = s.run
    kept = sorted(s.kept.values(), key=lambda x: x[0])
    ks = [k for _, k, _, _ in kept]
    prog = torch.as_tensor(np.stack([sc for _, _, sc, _ in kept]))
    draws = [tuple(torch.cat([d[j][g] for *_, d in kept]) for g in range(3)) for j in range(2)]
    sup_rows, qry_rows = s.sup_rows[ks], s.qry_rows[ks]
    s.trainer = s.host = s.kept = None
    if run.cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    r, faults = reference_scores(run, sup_rows, qry_rows, draws, "float32")
    s.check_seconds = time.perf_counter() - t0
    lim = run.limits["limits"]
    nums = compare.score_numbers(prog.to(r.device).reshape(-1, s.n), r.reshape(-1, s.n),
                                 torch.ones(r.shape[0] * r.shape[1], dtype=torch.bool, device=r.device))
    return {"draw_faults": dict(value=faults, limit=0),
            "score_err": dict(value=nums["score_err"], limit=lim["score_err"]),
            "argmax_gap": dict(value=nums["argmax_gap"], limit=lim["argmax_gap"])}


def reference_scores(run, sup_rows, qry_rows, draws, precision: str):
    """The reference's scores ``[R, Q, N]`` of the kept requests, as one
    batch of R episodes, and the faults of their draws."""
    cfg = run.config
    exp = cfg["experiment"]
    n, ks, _ = _params(run)
    f, t = cfg["dataset"]["feat_shape"]
    split = data.make_split(cfg["dataset"], run.seed, run.device)
    w = program.weights(cfg, run.seed, run.device)
    mv = float(exp["specaug_params"]["mask_value"])
    dev = run.device
    faults = sum(episodes.draw_faults(d, exp["specaug_params"], f, t) for d in draws)
    with torch.no_grad():
        sup = split["segments"][torch.as_tensor(sup_rows, device=dev)]
        qry = split["segments"][torch.as_tensor(qry_rows, device=dev)]
        sv = ref.views(sup, *draws[0], mv)
        qv = ref.views(qry, *draws[1], mv) if exp["test_query_augmentations"] else qry[:, :, None]
        labels = torch.arange(n, device=dev).repeat_interleave(ks).expand(sup.shape[0], -1)
        return ref.eval_scores(sv, qv, labels, n, w, cfg["model"], precision), faults
