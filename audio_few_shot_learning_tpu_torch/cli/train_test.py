"""Training/testing CLI, the reference entry point's counterpart:

    python -m audio_few_shot_learning_tpu_torch.cli.train_test \\
        -e experiment_config.json -m model_config.json

Reads the reference's two JSON schemas, as the JAX package's CLI does. It
runs on the card unless the experiment config says ``"device": "cpu"``.
Beyond the reference: ``--data-root`` (the reference hardcodes ``/data``),
``--experiments-root``, ``--runs`` (the reference hardcodes 5) and
``--resume`` (continue interrupted runs from their resume checkpoints).

Data-parallel over W cards, with ``"tpu": {"mesh_shape": W}`` in the
experiment config:

    torchrun --nproc_per_node W -m audio_few_shot_learning_tpu_torch.cli.train_test \\
        -e experiment_config.json -m model_config.json

Each rank joins the process group (``parallel/mesh.py::
maybe_initialize_distributed``: NCCL, or gloo for ``"device": "cpu"``) and
runs on ``cuda:LOCAL_RANK``; rank 0 writes the results.
"""

from __future__ import annotations

import argparse
import dataclasses


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument(
        "-e", "--experiment_config", help="Path to Experiment configuration file.", required=True
    )
    parser.add_argument("-m", "--model_config", help="Path to model_params file", required=True)
    parser.add_argument("--data-root", default=None, help="Dataset root (default: config/data_root)")
    parser.add_argument("--experiments-root", default="experiments")
    parser.add_argument("--runs", type=int, default=None, help="Override number of repeated runs")
    parser.add_argument("--resume", action="store_true", help="Resume interrupted runs")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    from audio_few_shot_learning_tpu_torch.config import load_configs
    from audio_few_shot_learning_tpu_torch.parallel.mesh import maybe_initialize_distributed
    from audio_few_shot_learning_tpu_torch.train.experiment import run_experiment

    exp, mdl = load_configs(args.experiment_config, args.model_config)
    # a torchrun launch joins its process group; a single process is a no-op
    maybe_initialize_distributed(backend="gloo" if exp.device == "cpu" else None)
    if args.data_root:
        exp = dataclasses.replace(exp, data_root=args.data_root)
    return run_experiment(
        exp,
        mdl,
        experiments_root=args.experiments_root,
        resume=args.resume,
        num_runs=args.runs,
    )


if __name__ == "__main__":
    main()
