#!/usr/bin/env python3
"""What TF32 changes on the flagship: cuDNN's default (TF32 on for cuDNN,
off for cuBLAS) against the port's setting (both off, ``device.py``).

    python3 scripts/torch_port_tf32_cost.py [--out build/torch_port_tf32_cost.json]

on one card (about a minute). Imports nothing of JAX. On the flagship CPL
configuration in bf16 (35 classes x 40 items of 128x157 seeded noise,
``parallel/dryrun.py``'s store), the settings alternate off, on, on, off,
each run measuring:

1. train ms per step at E=1: the median of 16 steps after 4 warm-up steps,
   CUDA events around each ``train_step``;
2. eval ms per batch at E=16: the median of 8 batches of
   ``Trainer._episode_scores`` after 2 warm-up batches;
3. the scores of one eval batch at E=16 from the same weights, episodes and
   SpecAugment draws, against the first run with TF32 off (largest and RMS
   difference, argmax agreement).

Then item 3 for the same model in float32, where TF32 would reach every
convolution, not only the recurrent layer after the conv stack. Prints
the card's name and power limit and one JSON line, and writes it to
``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

WARM_STEPS, STEPS = 4, 16
WARM_BATCHES, BATCHES = 2, 8
EVAL_E = 16
ORDER = (False, True, True, False)  # cuDNN TF32 per run


def median_ms(fn, warm: int, n: int) -> float:
    import numpy as np
    import torch

    for _ in range(warm):
        fn()
    times = []
    for _ in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=os.path.join(REPO, "build", "torch_port_tf32_cost.json"))
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("torch_port_tf32_cost: needs a CUDA device", file=sys.stderr)
        return 1
    from audio_few_shot_learning_tpu_torch.data.episodes import sample_episode
    from audio_few_shot_learning_tpu_torch.device import resolve_device
    from audio_few_shot_learning_tpu_torch.ops import cuda_build
    from audio_few_shot_learning_tpu_torch.ops.specaugment import draw_views_params
    from audio_few_shot_learning_tpu_torch.parallel.dryrun import N_WAY, dryrun_configs, dryrun_store
    from audio_few_shot_learning_tpu_torch.train.engine import Trainer

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    dev = resolve_device("cuda:0")
    cuda_build.build(["specaugment", "protohead", "mel"])
    store = dryrun_store("flagship", dev)
    f, t = store.feat_shape

    def trainers(dtype):
        exp, mdl, _ = dryrun_configs("flagship", 1, compute_dtype=dtype, tasks=STEPS, eval_batch=EVAL_E,
                                     device="cuda")
        train = Trainer(exp, mdl, store, val_store=store, test_store=store, seed=3, device=dev)
        evaluator = Trainer(exp, mdl, store, val_store=store, test_store=store, seed=3, device=dev)
        return train, evaluator

    # one fixed eval batch and its SpecAugment draws (support, queries), for the scores
    ep = sample_episode(torch.Generator(device=dev).manual_seed(5), store, N_WAY, N_WAY, N_WAY, EVAL_E)

    def fixed_draws(exp):
        return tuple(tuple(x.to(dev) for x in draw_views_params(torch.Generator().manual_seed(seed),
                                                                   exp.specaug_params, EVAL_E, N_WAY * N_WAY,
                                                                   f, t, "cpu"))
                     for seed in (6, 7))

    def scores(trainer, draws):
        with torch.inference_mode():
            return trainer._episode_scores(ep, N_WAY, True, trainer.gen, draws).float()

    def compare(ref, s):
        d = (s - ref).double()
        return dict(max_abs=d.abs().max().item(), rms=d.square().mean().sqrt().item(),
                    argmax_agree=(s.argmax(-1) == ref.argmax(-1)).float().mean().item(),
                    scale=ref.abs().max().item())

    runs = []
    train, evaluator = trainers("bfloat16")
    draws = fixed_draws(evaluator.exp)
    reference = None
    for tf32 in ORDER:
        torch.backends.cudnn.allow_tf32 = tf32
        train_ms = median_ms(lambda: train.train_step(sample_episode(train.gen, store, N_WAY, N_WAY, N_WAY, 1)),
                             WARM_STEPS, STEPS)

        def eval_batch():
            with torch.inference_mode():
                b = sample_episode(evaluator.gen, store, N_WAY, N_WAY, N_WAY, EVAL_E)
                evaluator._episode_scores(b, N_WAY, True, evaluator.gen)

        eval_ms = median_ms(eval_batch, WARM_BATCHES, BATCHES)
        s = scores(evaluator, draws)
        if reference is None:
            reference = s
        runs.append(dict(cudnn_tf32=tf32, train_ms_per_step=train_ms, eval_ms_per_batch=eval_ms,
                         scores_vs_first_tf32_off=compare(reference, s)))
        print(json.dumps(runs[-1]), flush=True)

    f32 = {}
    _, evaluator32 = trainers("float32")
    for tf32 in (False, True):
        torch.backends.cudnn.allow_tf32 = tf32
        f32[tf32] = scores(evaluator32, draws)
    resolve_device(dev)  # back to the port's setting
    by = {tf32: [r for r in runs if r["cudnn_tf32"] == tf32] for tf32 in (False, True)}
    out = dict(
        card=card, torch=torch.__version__, cuda=torch.version.cuda, runs=runs,
        bf16_train_ms_tf32_off=[r["train_ms_per_step"] for r in by[False]],
        bf16_train_ms_tf32_on=[r["train_ms_per_step"] for r in by[True]],
        bf16_eval_ms_tf32_off=[r["eval_ms_per_batch"] for r in by[False]],
        bf16_eval_ms_tf32_on=[r["eval_ms_per_batch"] for r in by[True]],
        bf16_scores_tf32_on_vs_off=[r["scores_vs_first_tf32_off"] for r in by[True]],
        bf16_scores_off_vs_off=by[False][1]["scores_vs_first_tf32_off"],
        float32_scores_tf32_on_vs_off=compare(f32[False], f32[True]),
    )
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(out, fh, indent=1)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
