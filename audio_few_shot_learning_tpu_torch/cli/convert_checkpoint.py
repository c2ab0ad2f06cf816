"""Convert model files between the JAX package and this package.

Both packages name their best model ``model.ckpt``, in two formats: the JAX
package writes flax msgpack, this package a ``torch.save`` state_dict with
the reference's keys (so also a reference ``model.pt``). The direction
comes from the input's first bytes, not its name:

* ``from-jax``: a JAX package ``model.ckpt`` -> this package's state_dict;
* ``to-jax``: this package's ``model.ckpt`` or a reference ``model.pt`` ->
  a file that the JAX package's ``train/checkpoint.py::load_model`` reads.

Either way the weights are loaded with ``strict=True`` into the model that
``-e/-m`` describe, so a file of another architecture fails here. For the
'CNN' encoder the head's width depends on the input geometry: give the
training features' ``--feat-shape F T`` (default 128 157). An 'AST' model
has no JAX counterpart and is refused by name. Conversion runs on the CPU
and needs no card.

    python -m audio_few_shot_learning_tpu_torch.cli.convert_checkpoint \\
        -e experiment_config.json -m model_config.json \\
        --input experiments/exp/model.ckpt --output model_for_jax.ckpt
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-e", "--experiment_config", required=True)
    p.add_argument("-m", "--model_config", required=True)
    p.add_argument("--input", required=True, help="a JAX package model.ckpt, or this package's / a reference model file")
    p.add_argument("--output", required=True)
    p.add_argument(
        "--direction",
        choices=["from-jax", "to-jax"],
        default=None,
        help="expected direction; by default read from the input's first bytes (a mismatch raises)",
    )
    p.add_argument(
        "--feat-shape", nargs=2, type=int, default=(128, 157), metavar=("F", "T"),
        help="feature geometry the model was trained on (default 128 157)",
    )
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    import torch

    from audio_few_shot_learning_tpu_torch.config import load_configs
    from audio_few_shot_learning_tpu_torch.models.protonets import FewShotEpisodeModel
    from audio_few_shot_learning_tpu_torch.train import checkpoint as ckpt
    from audio_few_shot_learning_tpu_torch.train.weights import refuse_ast

    exp, mdl = load_configs(args.experiment_config, args.model_config)
    refuse_ast(exp)
    direction = "from-jax" if ckpt.is_jax_model_file(args.input) else "to-jax"
    if args.direction is not None and args.direction != direction:
        raise ValueError(f"--direction {args.direction}, but {args.input} is read as {direction}")

    model = FewShotEpisodeModel(exp, mdl, tuple(args.feat_shape))
    if direction == "from-jax":
        model.load_state_dict(ckpt.load_jax_model(args.input), strict=True)
        ckpt.save_model(args.output, model)
    else:
        model.load_state_dict(torch.load(args.input, map_location="cpu", weights_only=True), strict=True)
        ckpt.save_jax_model(args.output, model.state_dict(), exp)
    n = sum(p.numel() for p in model.parameters())
    print(f"{direction}: {args.input} -> {args.output} ({n} parameters)")
    return direction


if __name__ == "__main__":
    main()
