"""Aggregate experiment results into summary tables (counterpart of the
JAX package's ``cli/aggregate_results.py``: the same tables from the same
artifacts).

The reference's analysis notebook (angle_statistics.ipynb) summarizes runs
from a hand-maintained spreadsheet; here the JSON/JSONL
artifacts (``train/experiment.py``: ``config.json``, ``result_run{i}.json``,
``metrics_run{i}.jsonl``) are aggregated directly:

    python -m audio_few_shot_learning_tpu_torch.cli.aggregate_results experiments/

Prints per-experiment mean±std test accuracy across repeated runs, best val
accuracy, epochs trained and episodes/sec, and (with --json) a machine-
readable dump.

``--sweep KEY`` reproduces the notebook's hyperparameter-sweep analysis
(e.g. the APL angle ∈ {0, 15, 30, 45} tables, angle_statistics.ipynb cell 4):
experiments are grouped by the value of a dotted key into their saved
``config.json`` (written by ``run_experiment``), and each group's run
accuracies are pooled. ``--sweep angle`` is shorthand for
``--sweep loss.angular.angle``.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Dict, List

import numpy as np


def collect(experiments_root: str) -> Dict[str, Dict]:
    out: Dict[str, Dict] = {}
    root = Path(experiments_root)
    if not root.is_dir():
        return out
    for exp_dir in sorted(p for p in root.iterdir() if p.is_dir()):
        runs: List[Dict] = []
        for rf in sorted(exp_dir.glob("result_run*.json")):
            with open(rf) as f:
                runs.append(json.load(f))
        config = None
        cfg_path = exp_dir / "config.json"
        if cfg_path.exists():
            with open(cfg_path) as f:
                config = json.load(f)
        epochs, eps = [], []
        for mf in sorted(exp_dir.glob("metrics_run*.jsonl")):
            with open(mf) as f:
                rows = [json.loads(line) for line in f if line.strip()]
            if rows:
                epochs.append(rows[-1]["epoch"])
                eps.extend(r.get("episodes_per_sec", np.nan) for r in rows)
        if not runs:
            continue
        accs = np.asarray([r["mean_accuracy"] for r in runs])
        out[exp_dir.name] = {
            "runs": len(runs),
            "run_accuracies": [float(a) for a in accs],
            "test_accuracy_mean": float(accs.mean()),
            "test_accuracy_std": float(accs.std()),
            "best_val_accuracy": float(
                np.max([r.get("best_val_accuracy", np.nan) for r in runs])
            ),
            "epochs_trained": epochs,
            "episodes_per_sec_mean": float(np.nanmean(eps)) if eps else None,
            "config": config,
        }
    return out


_SWEEP_SHORTHAND = {
    "angle": "loss.angular.angle",
    "l_param": "loss.l_param",
    "m_param": "loss.cpl.m_param",
    "t_param": "loss.cpl.t_param",
}


def _dig(d, dotted: str):
    for part in dotted.split("."):
        if not isinstance(d, dict) or part not in d:
            return None
        d = d[part]
    return d


def sweep(summary: Dict[str, Dict], key: str) -> Dict:
    """Group per-experiment results by a config hyperparameter value.

    Pools run accuracies per value of ``key`` (a dotted path into the saved
    experiment config) across all experiments that recorded a config.
    """
    dotted = _SWEEP_SHORTHAND.get(key, key)
    groups: Dict = {}
    skipped = []
    for name, s in summary.items():
        if not s.get("config"):
            skipped.append(name)
            continue
        val = _dig(s["config"].get("experiment", {}), dotted)
        if val is None:
            skipped.append(name)
            continue
        g = groups.setdefault(val, {"experiments": [], "accuracies": []})
        g["experiments"].append(name)
        g["accuracies"].extend(s["run_accuracies"])
    rows = {}
    for val in sorted(groups, key=lambda v: (str(type(v)), v)):
        a = np.asarray(groups[val]["accuracies"])
        rows[str(val)] = {
            "value": val,
            "experiments": groups[val]["experiments"],
            "runs": int(a.size),
            "test_accuracy_mean": float(a.mean()),
            "test_accuracy_std": float(a.std()),
        }
    return {"key": dotted, "groups": rows, "skipped": skipped}


def print_sweep(sw: Dict) -> None:
    """The sweep table: one row per value of the swept key."""
    print(f"sweep over {sw['key']}")
    print(f"{'value':>12} {'runs':>5} {'test acc':>18}  experiments")
    for row in sw["groups"].values():
        acc = f"{row['test_accuracy_mean']:.4f} ± {row['test_accuracy_std']:.4f}"
        print(
            f"{row['value']!s:>12} {row['runs']:>5} {acc:>18}  "
            + ",".join(row["experiments"])
        )


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("experiments_root", nargs="?", default="experiments")
    p.add_argument("--json", action="store_true", help="print machine-readable JSON")
    p.add_argument(
        "--sweep",
        default=None,
        metavar="KEY",
        help="group results by a config hyperparameter (dotted path into the "
        "experiment config, or a shorthand: angle, l_param, m_param, t_param)",
    )
    args = p.parse_args(argv)
    summary = collect(args.experiments_root)
    if args.sweep:
        sw = sweep(summary, args.sweep)
        if args.json:
            print(json.dumps(sw, indent=2))
            return sw
        print_sweep(sw)
        if sw["skipped"]:
            print(f"(skipped, no config.json or key absent: {', '.join(sw['skipped'])})")
        return sw
    if args.json:
        print(json.dumps(summary, indent=2))
        return summary
    if not summary:
        print(f"No results under {args.experiments_root}")
        return summary
    w = max(len(k) for k in summary) + 2
    print(f"{'experiment':<{w}} {'runs':>4} {'test acc':>18} {'best val':>9} {'eps/s':>8}")
    for name, s in summary.items():
        acc = f"{s['test_accuracy_mean']:.4f} ± {s['test_accuracy_std']:.4f}"
        eps = f"{s['episodes_per_sec_mean']:.1f}" if s["episodes_per_sec_mean"] else "-"
        print(f"{name:<{w}} {s['runs']:>4} {acc:>18} {s['best_val_accuracy']:>9.4f} {eps:>8}")
    return summary


if __name__ == "__main__":
    main()
