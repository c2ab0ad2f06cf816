#!/usr/bin/env python3
"""Cumulative anatomy of the flagship train step in the PyTorch/CUDA port:
the port's counterpart of ``scripts/step_anatomy.py``.

Five stages, each adding one part of the real step to the one before:

  sample    episodic sampling from the device store
  views     + SpecAugment's 4 views of support and queries (K1)
  forward   + the episode forward and loss in train mode, without gradients
  backward  + ``torch.autograd.grad`` of that loss (the engine's
            ``_loss_and_metrics``) over every parameter
  step      the engine's real ``Trainer.train_step`` (+ the Adam update)

The JAX script ran each stage as one jitted ``scan`` over steps, where the
host issues once; the port is eager, so a stage costs what the host takes to
issue it or what the device takes to run it, whichever is longer. For each
stage this reports both: its wall ms a step (the median interval between
CUDA events at the steps' boundaries over ``--steps`` steps after a
warm-up: the engine's step clock) and its device ms a step (the sum of
its kernels' time under ``torch.profiler`` over ``--profile-steps`` steps),
with their ratio, the busy share, and the deltas from stage to stage. Where
wall exceeds device the stage is host-bound. It runs at E=1 and at E=8 in
chunks of 4 (remat), where the step is device-bound; the launches of K1
(SpecAugment views), K2 (episode scores) and K3 (mel + log) per step of the
step stage are asserted (2 1 0 a chunk on the card, 0 0 0 on the CPU).

    python3 scripts/torch_port_step_anatomy.py [--steps 50] [--profile-steps 10] [--episode-batches 1 8]
        [--device cuda:0|cpu] [--out FILE]

Prints the card's name and power limit, a table a batch size and one JSON
line. Runs on ``cuda:0`` unless given ``--device cpu`` (where no device
figure is measured); with no card it raises. Imports nothing of JAX or of
the JAX package.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "scripts"))

import torch  # noqa: E402

import _torch_port_bench_setup as bench  # noqa: E402
from audio_few_shot_learning_tpu_torch.utils.profiling import card  # noqa: E402

STAGES = ("sample", "views", "forward", "backward", "step")
MICROBATCH = {8: 4}  # E=8 trains in chunks of 4, as the flagship's remat phase
SPEC_LAUNCHES = (2, 1, 0)  # K1, K2, K3 per chunk of a SpecAugment train step


def stage_fns(tr):
    """Stage name -> a function running one step of that stage; every stage
    goes through the step's batch in its chunks (``episode_microbatch``), as
    ``train_step`` does."""
    from audio_few_shot_learning_tpu_torch.train.engine import _slice_tree

    exp = tr.exp
    n_way, k_shot, k_query = exp.n_way_train, exp.n_shot_train, exp.n_query_train
    vq = tr._v_query(exp.train_query_augmentations)
    batches = tr._batches(tr.train_store, n_way, k_shot, k_query)
    params = [p for p in tr.model.parameters() if p.requires_grad]
    e = tr.episode_batch
    size = tr.microbatch or e

    def chunks():
        ep = batches(e)
        return [_slice_tree(ep, slice(c * size, (c + 1) * size)) for c in range(e // size)]

    def sample():
        return batches(e)

    def views():
        return [(tr._make_views(ch.support, tr.specaug, tr.gen), tr._make_views(ch.query, vq > 1, tr.gen))
                for ch in chunks()]

    def forward():
        tr.model.train()
        with torch.no_grad():
            return [tr._loss_and_metrics(ch)[0] for ch in chunks()]

    def backward():
        tr.model.train()
        parts = chunks()
        return [torch.autograd.grad(tr._loss_and_metrics(ch)[0] / len(parts), params, allow_unused=True)
                for ch in parts]

    def step():
        return tr.train_step(batches(e))

    return dict(sample=sample, views=views, forward=forward, backward=backward, step=step)


def measure_stage(fn, steps: int, profile_steps: int, device, warmup: int = 5) -> dict:
    from audio_few_shot_learning_tpu_torch.utils.profiling import mark, mark_intervals, marks_made

    for _ in range(warmup):
        fn()
    first = marks_made()
    for _ in range(steps):
        mark(device, "anatomy")
        fn()
    mark(device, "anatomy", end=True)
    bench.sync(device)
    wall = statistics.median(m["ms"] for m in mark_intervals("anatomy", first))
    prof = bench.device_profile(fn, profile_steps, device)
    dev_ms = prof["device_ms"]
    return dict(wall_ms=wall, device_ms=dev_ms, wall_over_device=None if dev_ms is None else wall / dev_ms,
                busy_share=prof["busy_share"], profiled_wall_ms=prof["wall_ms"], by_family=prof["by_family"])


def anatomy(episode_batch: int, steps: int, profile_steps: int, device) -> dict:
    from audio_few_shot_learning_tpu_torch.train.engine import Trainer
    from audio_few_shot_learning_tpu_torch.utils.profiling import launches_per_call, tally_launches

    store = bench.make_store(device=device)
    tr = bench.make_trainer(episode_batch, MICROBATCH.get(episode_batch), store=store, device=device)
    fns = stage_fns(tr)
    rows, prev_wall, prev_dev = {}, 0.0, 0.0
    for name in STAGES:
        calls = []
        with launches_per_call(Trainer, "train_step", calls):
            row = measure_stage(fns[name], steps, profile_steps, device)
        row["delta_wall_ms"] = row["wall_ms"] - prev_wall
        row["delta_device_ms"] = None if row["device_ms"] is None else row["device_ms"] - prev_dev
        prev_wall, prev_dev = row["wall_ms"], row["device_ms"] or 0.0
        if name == "step":
            row["launches_per_step"] = tally_launches(calls)
            chunks = episode_batch // (MICROBATCH.get(episode_batch) or episode_batch)
            want = [n * chunks for n in SPEC_LAUNCHES] if device.type == "cuda" else [0, 0, 0]
            if set(row["launches_per_step"]) != {" ".join(map(str, want))}:
                raise AssertionError(f"E={episode_batch}: launches per step {row['launches_per_step']}, "
                                     f"expected {want}")
        rows[name] = row
    return dict(episode_batch=episode_batch, microbatch=MICROBATCH.get(episode_batch), remat=tr.exp.tpu.remat_enabled(),
                steps=steps, profile_steps=profile_steps, stages=rows)


def table(run: dict) -> str:
    fmt = lambda x: "not measured" if x is None else f"{x:.2f}"  # noqa: E731
    lines = [f"E={run['episode_batch']}" + (f" in chunks of {run['microbatch']}" if run["microbatch"] else ""),
             f"{'stage':<10}{'wall ms':>10}{'delta':>10}{'device ms':>14}{'delta':>14}{'busy':>8}"]
    for name, r in run["stages"].items():
        busy = "" if r["busy_share"] is None else f"{r['busy_share']:.2f}"
        lines.append(f"{name:<10}{r['wall_ms']:>10.2f}{r['delta_wall_ms']:>10.2f}{fmt(r['device_ms']):>14}"
                     f"{fmt(r['delta_device_ms']):>14}{busy:>8}")
    return "\n".join(lines)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--profile-steps", type=int, default=10)
    ap.add_argument("--episode-batches", type=int, nargs="+", default=[1, 8])
    ap.add_argument("--device", default="cuda:0", help="cuda:N (default cuda:0) or cpu")
    ap.add_argument("--out", help="also write the JSON line to this file")
    args = ap.parse_args(argv)

    from audio_few_shot_learning_tpu_torch.device import resolve_device

    device = resolve_device(args.device)  # no card and no --device cpu raises here
    out = {"card": card()["nvidia_smi"] if device.type == "cuda" else None, "torch": torch.__version__,
           "device": device.type, "runs": []}
    print(f"card: {out['card']}", flush=True)
    for e in args.episode_batches:
        run = anatomy(e, args.steps, args.profile_steps, device)
        out["runs"].append(run)
        print(table(run), flush=True)
    line = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line, flush=True)
    return out


if __name__ == "__main__":
    main()
