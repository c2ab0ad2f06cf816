#!/usr/bin/env python3
"""Leave-one-out cost of each WaveAugment transform inside the real train
step of the PyTorch/CUDA port: the port's counterpart of
``scripts/profile_wav_path.py``.

For each variant it builds the flagship wav trainer (``bench.make_trainer(1,
wav=True)``: Hybrid + attention + CPL, 5-way 5-shot 5-query, WaveAugment on
with aug_num 3, so 4 views; the 12 x 20 store of 5-s clips), trains one
warm-up epoch and two more of 20 steps, and reports the best episodes/s,
the median train step (the engine's step clock), and the device ms a step
(the sum of the step's kernels under ``torch.profiler`` over ``--profile-
steps`` steps) and the chain's device ms (full minus chain-off). The
variants:

  full            the benchmarked wav configuration (every default probability)
  +fuse_lowpass   the low-pass joins the shared spectrum group
  -<name>         leave-one-out: that transform's probability 0, which
                  leaves it out of the chain (``ops/waveaugment.py``:
                  ``WaveAugment._steps`` skips a transform of probability 0)
  chain-off       every probability 0: the sampler, the log-mel (K3) and the
                  model alone

A transform's cost is the full variant's ms an episode minus its
leave-one-out variant's, in wall and in device time. Launches of K1 (SpecAugment views), K2 (episode
scores) and K3 (mel + log) per train step are asserted: 0 1 1 on the card,
0 0 0 on the CPU.

    python3 scripts/torch_port_profile_wav_path.py [--variants=full,-gain,...] [--profile-steps 10]
        [--device cuda:0|cpu] [--out FILE]

Prints the card's name and power limit, a markdown table and one JSON line.
Runs on ``cuda:0`` unless given ``--device cpu`` (where no device figure is
measured); with no card it raises. Imports nothing of JAX or of the JAX
package.
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

# transform -> the raw-dict probability key whose 0 leaves it out of the chain
# (timeinversion and timestretch default to 0 and are not in the chain)
PROB_KEYS = {
    "lowpass": "lowpass_p",
    "pitchshift": "pitchshift_p",
    "shift": "shift_p",
    "gain": "gain_p",
    "noise": "noise_p",
    "highpass": "highpass_p",
    "bandstop": "bandstop_p",
    "spliceout": "spliceout_p",
    "timemasking": "timemasking_p",
}
WAV_LAUNCHES = (0, 1, 1)  # K1, K2, K3 per wav train step


def variants() -> dict:
    """Variant name -> the WaveAugment raw-dict overrides (the JAX script's)."""
    out = {"full": {}, "+fuse_lowpass": {"fuse_lowpass": True}}
    out.update({f"-{name}": {key: 0.0} for name, key in PROB_KEYS.items()})
    out["chain-off"] = {key: 0.0 for key in PROB_KEYS.values()}
    return out


def bench_variant(overrides: dict, store, device, repeats: int, profile_steps: int) -> dict:
    from audio_few_shot_learning_tpu_torch.train.engine import Trainer
    from audio_few_shot_learning_tpu_torch.utils.profiling import launches_per_call, tally_launches

    tr = bench.make_trainer(1, wav=True, store=store, device=device, waveaug=overrides)
    steps = []
    with launches_per_call(Trainer, "train_step", steps):
        tr.train_epoch()  # first plans
        epochs = [tr.train_epoch() for _ in range(repeats)]
        step_ms = statistics.median(tr.last_step_ms)
    exp = tr.exp
    batches = tr._batches(tr.train_store, exp.n_way_train, exp.n_shot_train, exp.n_query_train)
    prof = bench.device_profile(lambda: tr.train_step(batches(1)), profile_steps, device)
    want = " ".join(map(str, WAV_LAUNCHES if device.type == "cuda" else (0, 0, 0)))
    launches = tally_launches(steps)
    if set(launches) != {want}:
        raise AssertionError(f"launches per wav train step {launches}; expected {want}")
    eps = max(m["episodes_per_sec"] for m in epochs)
    return dict(eps=eps, ms_per_episode=1e3 / eps, step_ms_median=step_ms, device_ms=prof["device_ms"],
                busy_share=prof["busy_share"], by_family=prof["by_family"], launches_per_step=launches,
                loss=epochs[-1]["loss"])


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", help="the variants to run, comma-separated names (--variants=full,-gain; "
                                       "default: all, in order)")
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--profile-steps", type=int, default=10)
    ap.add_argument("--device", default="cuda:0", help="cuda:N (default cuda:0) or cpu")
    ap.add_argument("--out", help="also write the JSON line to this file")
    args = ap.parse_args(argv)

    from audio_few_shot_learning_tpu_torch.device import resolve_device

    device = resolve_device(args.device)  # no card and no --device cpu raises here
    table = variants()
    names = args.variants.split(",") if args.variants else list(table)
    unknown = set(names) - set(table)
    if unknown:
        raise ValueError(f"unknown variants {sorted(unknown)}; known: {list(table)}")
    out = {"card": card()["nvidia_smi"] if device.type == "cuda" else None, "torch": torch.__version__,
           "device": device.type, "variants": {}}
    print(f"card: {out['card']}", flush=True)
    store = bench.make_wav_store(device)
    for name in names:
        row = bench_variant(table[name], store, device, args.repeats, args.profile_steps)
        out["variants"][name] = row
        print(f"{name}: {row['eps']:.2f} eps/s, step {row['step_ms_median']:.2f} ms, device "
              f"{row['device_ms'] if row['device_ms'] is None else round(row['device_ms'], 2)} ms", flush=True)
    full = out["variants"].get("full")
    lines = ["| variant | eps/s | ms/episode | step ms (median) | device ms/step | transform cost ms | "
             "transform device ms |", "|---|---|---|---|---|---|---|"]
    for name, r in out["variants"].items():
        cost = full["ms_per_episode"] - r["ms_per_episode"] if full and name.startswith("-") else None
        r["transform_cost_ms"] = cost
        r["transform_device_cost_ms"] = (full["device_ms"] - r["device_ms"]
                                         if cost is not None and r["device_ms"] is not None else None)
        fmt = lambda v, nd, none="—": none if v is None else f"{v:.{nd}f}"  # noqa: E731
        lines.append(f"| {name} | {r['eps']:.2f} | {r['ms_per_episode']:.1f} | {r['step_ms_median']:.2f} | "
                     f"{fmt(r['device_ms'], 2, 'not measured')} | {fmt(cost, 1)} | "
                     f"{fmt(r['transform_device_cost_ms'], 2)} |")
    off = out["variants"].get("chain-off")
    if full and off and full["device_ms"] is not None:
        out["chain_device_ms"] = full["device_ms"] - off["device_ms"]
        out["chain_device_share"] = out["chain_device_ms"] / full["device_ms"]
    print("\n".join(lines), flush=True)
    line = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line, flush=True)
    return out


if __name__ == "__main__":
    main()
