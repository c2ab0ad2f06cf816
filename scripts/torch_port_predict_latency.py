#!/usr/bin/env python3
"""Latency of ``Trainer.predict_episode`` on the flagship model in the
PyTorch/CUDA port: the port's counterpart of ``scripts/predict_latency.py``.

One 5-way 5-shot episode with 10 queries of 128x157 against a trainer on a
6 x 10 item store (the JAX script's shapes and ``default_rng(0)`` draws):

* the kernels K1-K3 are built first (``cuda_build.build``, ``nvcc`` for
  ``sm_90a``; its seconds reported apart, 0 when they were built before);
* cold: the first ``predict_episode`` call in the process, so cuDNN's first
  plans and the kernels' loading are in it and ``nvcc`` is not;
* warm: the median of 30 more calls (each returns numpy, so it has
  synchronized), and queries a second;
* bf16 inputs: the support and queries rounded to bf16 give the same
  predictions as float32, as the share of equal predictions. The JAX
  script also counts the jit cache entries that float32 and bf16 inputs
  make; the eager port compiles nothing per dtype, so that count has no
  counterpart. ``predict_episode`` takes numpy arrays; a caller holding bf16
  data passes it as float32 values (numpy has no bf16).

Launches of K1 (SpecAugment views), K2 (episode scores) and K3 (mel + log)
per call are asserted: 2 1 0 on the card, 0 0 0 on the CPU.

    python3 scripts/torch_port_predict_latency.py [--calls 30] [--device cuda:0|cpu] [--out FILE]

Prints the card's name and power limit and one JSON line. Runs on
``cuda:0`` unless given ``--device cpu`` (where the latencies are the CPU's,
not the card's); with no card it raises. Imports nothing of JAX or of the
JAX package.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "scripts"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import _torch_port_bench_setup as bench  # noqa: E402
from audio_few_shot_learning_tpu_torch.utils.profiling import card  # noqa: E402

SPEC_LAUNCHES = [2, 1, 0]  # K1, K2, K3 per prediction


def inputs():
    """The JAX script's store items and episode, in its draw order."""
    rng = np.random.default_rng(0)
    items = [rng.standard_normal((bench.N_MELS, bench.N_FRAMES)).astype(np.float32) for _ in range(60)]
    sup = rng.standard_normal((25, bench.N_MELS, bench.N_FRAMES)).astype(np.float32)
    qry = rng.standard_normal((10, bench.N_MELS, bench.N_FRAMES)).astype(np.float32)
    return items, sup, np.repeat(np.arange(5), 5), qry


def to_bf16_values(x: np.ndarray) -> np.ndarray:
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--calls", type=int, default=30)
    ap.add_argument("--device", default="cuda:0", help="cuda:N (default cuda:0) or cpu")
    ap.add_argument("--out", help="also write the JSON line to this file")
    args = ap.parse_args(argv)

    from audio_few_shot_learning_tpu_torch.config import ExperimentConfig, ModelConfig
    from audio_few_shot_learning_tpu_torch.data.store import PackedStore
    from audio_few_shot_learning_tpu_torch.device import resolve_device
    from audio_few_shot_learning_tpu_torch.ops import cuda_build
    from audio_few_shot_learning_tpu_torch.train.engine import Trainer
    from audio_few_shot_learning_tpu_torch.utils.profiling import kernel_counters

    device = resolve_device(args.device)  # no card and no --device cpu raises here
    cuda = device.type == "cuda"
    build_s = None
    if cuda:
        t0 = time.perf_counter()
        cuda_build.build(["specaugment", "protohead", "mel"])
        build_s = time.perf_counter() - t0
    items, sup, lab, qry = inputs()
    d = {**bench.FLAGSHIP_EXPERIMENT, "tpu": {"episode_batch": 1, "eval_episode_batch": 8}}
    store = PackedStore.pack(items, list(np.repeat(np.arange(6), 10)), n_classes=6, device=device)
    tr = Trainer(ExperimentConfig.from_dict(d), ModelConfig.from_dict(bench.MODEL_CONFIG), store, val_store=store,
                 test_store=store, device=device)
    counters = kernel_counters()
    for k in counters:
        k.launches = 0
    t0 = time.perf_counter()
    tr.predict_episode(sup, lab, qry)  # cold: cuDNN's first plans, the kernels' loading
    cold = time.perf_counter() - t0
    cold_launches = [k.launches for k in counters]
    times = []
    for _ in range(args.calls):
        t0 = time.perf_counter()
        tr.predict_episode(sup, lab, qry)  # returns numpy: synchronized
        times.append(time.perf_counter() - t0)
    warm = statistics.median(times)
    pred_f32, scores_f32 = tr.predict_episode(sup, lab, qry)
    pred_bf16, scores_bf16 = tr.predict_episode(to_bf16_values(sup), lab, to_bf16_values(qry))
    want = SPEC_LAUNCHES if cuda else [0, 0, 0]
    if cold_launches != want:
        raise AssertionError(f"launches of one prediction {cold_launches}; expected {want}")
    out = {
        "card": card()["nvidia_smi"] if cuda else None, "torch": torch.__version__, "device": device.type,
        "kernel_build_seconds": build_s, "cold_seconds": cold, "warm_median_ms": 1e3 * warm,
        "warm_min_ms": 1e3 * min(times), "warm_calls": args.calls, "queries_per_sec": len(qry) / warm,
        "launches_per_call": cold_launches,
        "bf16_agree": float((pred_f32 == pred_bf16).mean()),
        "bf16_max_abs_score_dev": float(np.abs(scores_f32 - scores_bf16).max()),
        "jax_cache_entries": "no counterpart: the eager port compiles nothing per input dtype",
    }
    print(f"card: {out['card']}", flush=True)
    print(f"predict_episode flagship 5w5s, 10 queries: cold {cold:.2f}s (kernels built beforehand in "
          f"{build_s if build_s is None else round(build_s, 1)} s), warm median {1e3 * warm:.1f} ms "
          f"({len(qry) / warm:.0f} queries/s); bf16 inputs agree {out['bf16_agree']}", flush=True)
    line = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line, flush=True)
    return out


if __name__ == "__main__":
    main()
