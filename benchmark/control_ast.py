#!/usr/bin/env python3
"""The controls of an AST training cell's check (``traffic/train_ast.py``),
as ``control.py`` gives them for the ``train`` kind: the plain reference
(``reference/ast.py``) in the program's place in float8, one precision below
the configuration's bfloat16, and in float32 with half of the queries left
out, on the episodes and draws the program's feed gives a run's first
steps; each compared with the float32 reference by the cell's own numbers.
Prints one JSON line per seed.

    python3 benchmark/control_ast.py --workload esc50_ast_cpl.train_e1 --seeds 11 12 13

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

from benchmark import harness  # noqa: E402
from benchmark.control import _free, half_batch  # noqa: E402


def controls(run) -> dict:
    kind = harness.load_module(harness.HERE / "traffic" / "train_ast.py", "benchmark_traffic_train_ast")
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


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda:0")
    args = p.parse_args(argv)
    for seed in args.seeds:
        run = harness.Run(args.workload, seed, 0.0, False, args.device, None)
        print(json.dumps({"workload": args.workload, "seed": seed, **controls(run)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
