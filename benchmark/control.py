#!/usr/bin/env python3
"""The controls of the check that decides ``correct``, at a cell's own size:
the plain reference put in the program's place and computed one precision
below the configuration's (float8 for its bfloat16), and for a training
cell a fault planted in that reference (half of the queries left out, the
mean taken over the rest), on the episodes and draws the program's feed
gives a run's first units. Each is compared with the float32 reference by
the cell's own numbers. Prints one JSON line per seed and control.

    python3 benchmark/control.py --workload <cell> --seeds 11 12 13

The benchmark's runs never run this; the limits in ``workloads/<cell>.json``
lie between the program's readings and these.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if sys.path and Path(sys.path[0]).resolve() == ROOT / "benchmark":
    sys.path[0] = str(ROOT)

import torch  # noqa: E402

from benchmark import harness  # noqa: E402
from benchmark.reference import compare  # noqa: E402


def half_batch(step: int, ep: dict) -> dict:
    """Every other query left out; the losses' means over the rest."""
    idx = torch.arange(0, ep["query"].shape[1], 2, device=ep["query"].device)
    ys, tmask, fmask = ep["qry_draws"]
    return {**ep, "query": ep["query"][:, idx], "query_labels": ep["query_labels"][:, idx],
            "qry_draws": (ys[:, idx], tmask, fmask), "gumbel": ep["gumbel"][:, idx][..., idx]}


def train_controls(run) -> dict:
    kind = harness.load_module(harness.HERE / "traffic" / "train.py", "benchmark_traffic_train")
    s = kind.setup(run)  # the program's first steps: their episodes and draws
    kept = [s.kept[i] for i in range(s.check_steps)]
    spe = s.trainer.steps_per_epoch
    s.trainer = s.store = None
    _free(run)
    limits = run.limits["limits"]
    r32 = kind.reference_numbers(run, kept, spe, "float32")
    out = {}
    for name, precision, mutate in (("float8", "float8", None), ("half_batch", "float32", half_batch)):
        r = kind.reference_numbers(run, kept, spe, precision, mutate)
        nums = kind.numbers_vs(kind.readings(r), r32, limits)
        out[name] = {**{k: v["value"] for k, v in nums.items() if k != "readings"}, **nums["readings"]}
    return out


def eval_controls(run, kind_name: str) -> dict:
    kind = harness.load_module(harness.HERE / "traffic" / f"{kind_name}.py", f"benchmark_traffic_{kind_name}")
    s = kind.setup(run)
    s.in_window = True  # the first units fill the sample
    for i in range(int(run.limits["check_units"])):
        kind.unit(s, i)
    n = s.n
    kept = sorted(s.kept.values(), key=lambda x: x[0])
    if kind_name == "predict":
        ks = [k for _, k, _, _ in kept]
        draws = [tuple(torch.cat([d[j][g] for *_, d in kept]) for g in range(3)) for j in range(2)]
        rows = (s.sup_rows[ks], s.qry_rows[ks])
        s.trainer = s.host = s.kept = None
        _free(run)
        ref = {p: [(kind.reference_scores(run, *rows, draws, p)[0], None)] for p in ("float32", "float8")}
    else:
        inputs = [(ep, draws) for _, ep, draws, _, _ in kept]
        s.trainer = s.store = s.kept = s.accs = None
        _free(run)
        ref = {p: [(sc, real) for sc, real, *_ in kind.reference_scores(run, inputs, p)[0]]
               for p in ("float32", "float8")}
    worst = dict(score_err=0.0, argmax_gap=0.0)
    for (r32, real), (r8, _) in zip(ref["float32"], ref["float8"]):
        real = torch.ones(r32.shape[:2], dtype=torch.bool, device=r32.device) if real is None else real
        nums = compare.score_numbers(r8.reshape(-1, n), r32.reshape(-1, n), real.reshape(-1))
        worst = {m: max(worst[m], nums[m]) for m in worst}
    return {"float8": worst}


def _free(run) -> None:
    if run.device.type == "cuda":
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda:0")
    args = p.parse_args(argv)
    for seed in args.seeds:
        run = harness.Run(args.workload, seed, 0.0, False, args.device, None)
        kind = run.mix["kind"]
        out = train_controls(run) if kind == "train" else eval_controls(run, kind)
        print(json.dumps({"workload": args.workload, "seed": seed, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
