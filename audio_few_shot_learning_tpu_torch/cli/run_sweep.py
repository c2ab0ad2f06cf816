"""Hyperparameter-sweep runner (counterpart of the JAX package's
``cli/run_sweep.py``), the reference's sweep workflow in one command.

The reference's APL angle sweeps (angle_statistics.ipynb) were produced by
hand-editing configs, re-launching src/train_test.py per value, and collating
results in a spreadsheet. Here one command runs the grid and prints the table:

    python -m audio_few_shot_learning_tpu_torch.cli.run_sweep \\
        -e experiment_config.json -m model_config.json \\
        --key loss.angular.angle --values 0 15 30 45

Each value gets its own experiment folder (``<base>_<leaf>=<value>``),
written by ``train/experiment.py::run_experiment``, so
``aggregate_results --sweep`` reads the grid back at any time; the sweep
table is printed at the end from the same aggregation code. The runs take
the card unless the config says ``"device": "cpu"``; under ``torchrun
--nproc_per_node W`` with ``"tpu": {"mesh_shape": W}`` every run is
data-parallel over W ranks, and rank 0 writes and prints.
"""

from __future__ import annotations

import argparse
import copy
import json


def set_dotted(d: dict, dotted: str, value):
    """Set a dotted key in a nested dict, creating intermediate dicts."""
    parts = dotted.split(".")
    for p in parts[:-1]:
        d = d.setdefault(p, {})
        if not isinstance(d, dict):
            raise ValueError(f"config key {dotted!r}: {p!r} is not an object")
    d[parts[-1]] = value


def _parse_value(s: str):
    try:
        return json.loads(s)
    except json.JSONDecodeError:
        return s  # bare string value


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("-e", "--experiment_config", required=True)
    p.add_argument("-m", "--model_config", required=True)
    p.add_argument(
        "--key",
        required=True,
        help="dotted path into the experiment config, or a shorthand "
        "(angle, l_param, m_param, t_param)",
    )
    p.add_argument(
        "--values",
        required=True,
        nargs="+",
        help="values to sweep (JSON literals; bare words are strings)",
    )
    p.add_argument("--experiments-root", default="experiments")
    p.add_argument("--runs", type=int, default=None, help="runs per value (default: config)")
    p.add_argument("--data-root", default=None)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    from audio_few_shot_learning_tpu_torch.cli.aggregate_results import (
        _SWEEP_SHORTHAND,
        collect,
        print_sweep,
        sweep,
    )
    from audio_few_shot_learning_tpu_torch.config import ExperimentConfig, ModelConfig
    from audio_few_shot_learning_tpu_torch.parallel.mesh import maybe_initialize_distributed, process_rank
    from audio_few_shot_learning_tpu_torch.train import experiment

    dotted = _SWEEP_SHORTHAND.get(args.key, args.key)
    with open(args.experiment_config) as f:
        base_exp = json.load(f)
    maybe_initialize_distributed(backend="gloo" if base_exp.get("device") == "cpu" else None)
    main = process_rank() == 0
    with open(args.model_config) as f:
        mdl = ModelConfig.from_dict(json.load(f))
    if args.data_root:
        base_exp["data_root"] = args.data_root

    base_folder = base_exp.get("experiment_folder", "default")
    leaf = dotted.rsplit(".", 1)[-1]
    for raw in args.values:
        value = _parse_value(raw)
        exp_dict = copy.deepcopy(base_exp)
        set_dotted(exp_dict, dotted, value)
        exp_dict["experiment_folder"] = f"{base_folder}_{leaf}={value}"
        exp = ExperimentConfig.from_dict(exp_dict)
        exp.validate()
        if main:
            print(f"=== sweep {dotted} = {value} -> {exp.experiment_folder} ===")
        experiment.run_experiment(
            exp, mdl, experiments_root=args.experiments_root, num_runs=args.runs
        )

    sw = sweep(collect(args.experiments_root), dotted)
    if main:
        print_sweep(sw)
    return sw


if __name__ == "__main__":
    main()
