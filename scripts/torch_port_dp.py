#!/usr/bin/env python3
"""Episode-axis data parallelism on 4 cards of one host (NCCL), against one
card in the same call.

    python3 scripts/torch_port_dp.py [--out build/torch_port_dp.json]

on a host with 4 cards (a few minutes). Imports nothing of JAX. It prints the cards' names and power limits, builds
the kernels once (the ranks load them), then:

1. ``parallel/dryrun.py::dryrun_multichip(4, "nccl", "cuda", "flagship")``:
   the dry run's checks at the published widths in float32, one episode
   per rank;
2. rates of the flagship CPL configuration in bf16 (35 classes x 40 items of
   128x157 seeded noise on every card), one card alone (no process group),
   then 4 ranks, then one card again: train ms per step (median over the
   second of two epochs of 8 steps, CUDA events) and episodes/s at a global
   E of 4 and 16 (4 cards: 1 and 4 per rank; remat on, as the config's rule
   gives at E >= 4), and eval episodes/s over 256 tasks at E=16 (one card)
   and E=64 (16 per rank); NCCL's kernels and device time per train step
   and the device's busy share under ``torch.profiler`` over 3 steps
   (every rank takes them; rank 0's are reported);
3. prints one JSON line of all of it, and writes all of it to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

TRAIN_E = (4, 16)
STEPS = 8
EVAL_TASKS = 256
PROFILE_STEPS = 3


def card_lines() -> list:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()


def rates(data_parallel: bool) -> dict:
    """One rank's part of the rate runs: train at each global E, then eval.
    Without ``data_parallel`` the rank runs alone, outside its group."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from audio_few_shot_learning_tpu_torch.data.episodes import sample_episode
    from audio_few_shot_learning_tpu_torch.parallel.dryrun import dryrun_configs, dryrun_store
    from audio_few_shot_learning_tpu_torch.parallel.mesh import EpisodeMesh, local_rank, make_mesh
    from audio_few_shot_learning_tpu_torch.train.engine import Trainer

    dev = torch.device(f"cuda:{local_rank()}")
    mesh = make_mesh(device=dev) if data_parallel else EpisodeMesh(0, 1, dev)
    store = dryrun_store("flagship", dev)
    out = dict(world=mesh.world, rank=mesh.rank, train={}, eval={})
    for e in TRAIN_E:
        exp, mdl, _ = dryrun_configs("flagship", e, compute_dtype="bfloat16", tasks=STEPS * e, device="cuda")
        trainer = Trainer(exp, mdl, store, seed=0, mesh=mesh)
        trainer.train_epoch()  # cuDNN's plans
        metrics = trainer.train_epoch()
        med = float(np.median(trainer.last_step_ms))
        row = dict(episodes_per_rank=e // mesh.world, remat=exp.tpu.remat_enabled(), step_ms=trainer.last_step_ms,
                   step_ms_median=med, step_ms_min=min(trainer.last_step_ms), episodes_per_s=1e3 * e / med,
                   loss=metrics["loss"], peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
        # every rank takes the profiled steps: each step's collectives need them all
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILE_STEPS):
                trainer.train_step(sample_episode(trainer.gen, store, 5, 5, 5, e // mesh.world))
            torch.cuda.synchronize(dev)
        wall_us = 1e6 * (time.perf_counter() - t0)
        kernels = [evt for evt in prof.key_averages() if str(getattr(evt, "device_type", "")).endswith("CUDA")
                   and not getattr(evt, "is_user_annotation", False)]  # the program's spans' device mirrors
        us = lambda evt: float(getattr(evt, "self_device_time_total", 0) or 0)  # noqa: E731
        nccl = [evt for evt in kernels if "nccl" in evt.key.lower()]
        row.update(nccl_kernels_per_step=sum(evt.count for evt in nccl) / PROFILE_STEPS,
                   nccl_us_per_step=sum(us(evt) for evt in nccl) / PROFILE_STEPS,
                   device_busy_share=sum(us(evt) for evt in kernels) / wall_us)
        out["train"][e] = row
        del trainer
    e = 16 * mesh.world
    exp, mdl, _ = dryrun_configs("flagship", mesh.world, compute_dtype="bfloat16", eval_batch=e, device="cuda")
    trainer = Trainer(exp, mdl, store, test_store=store, seed=0, mesh=mesh)
    trainer.evaluate(store, e, 5, 5, 5, True)  # cuDNN's plans
    trainer.evaluate(store, EVAL_TASKS, 5, 5, 5, True)
    out["eval"] = dict(eval_batch=e, per_rank=trainer.last_eval_batch, seconds=trainer.last_eval_seconds,
                       episodes_per_s=EVAL_TASKS / trainer.last_eval_seconds)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", default=os.path.join(REPO, "build", "torch_port_dp.json"))
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        print("torch_port_dp: needs 4 CUDA devices", file=sys.stderr)
        return 1
    from audio_few_shot_learning_tpu_torch.ops import cuda_build
    from audio_few_shot_learning_tpu_torch.parallel.dryrun import dryrun_multichip
    from audio_few_shot_learning_tpu_torch.parallel.spawn import run_ranks

    started = time.perf_counter()
    cards = card_lines()
    print(f"cards: {cards}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    cuda_build.build(["specaugment", "protohead", "mel"])
    result = dict(cards=cards)
    t0 = time.perf_counter()
    result["dryrun"] = dryrun_multichip(4, "nccl", "cuda", width="flagship", timeout_s=600)
    result["dryrun"]["seconds"] = time.perf_counter() - t0
    print("dry run: " + json.dumps(result["dryrun"]), flush=True)
    for name, world, dp in (("one_card_first", 1, False), ("four_cards", 4, True), ("one_card_second", 1, False)):
        t0 = time.perf_counter()
        ranks = run_ranks(rates, world, (dp,), backend="nccl", timeout_s=600)
        result[name] = dict(rank0=ranks[0], seconds=time.perf_counter() - t0,
                            ranks_train_step_ms_median={e: [r["train"][e]["step_ms_median"] for r in ranks]
                                                        for e in TRAIN_E})
        print(f"{name}: " + json.dumps(result[name]), flush=True)
    result["seconds"] = time.perf_counter() - started
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps({k: v for k, v in result.items() if k != "dryrun"}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
