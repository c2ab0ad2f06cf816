"""Does the conv bias's second rounding move bf16 running statistics? A CPU
diagnostic of the port's bf16 train step.

On the card a bf16 conv with a bias runs as cuDNN's conv, whose output is
rounded to bf16, then a separate bf16 ``add_`` of the bias, rounded again
(as the JAX package computes it); on the CPU oneDNN adds the bias inside
the conv and rounds once. ``chip_smoke.py``'s bf16 phase found the card's
running statistics 1.7-1.8x further from its float32 run than the CPU's.
This script runs one flagship train step at E=1 on the CPU from the same
weights, episode and draws (SpecAugment views, view permutations, CPL
draws; every dropout at p = 0) in four ways:

* ``bf16``: bf16 as the port computes it (the bias inside ``F.conv2d``);
* ``bf16_split_bias``: bf16 with each conv block's bias added by a separate
  bf16 add after a bias-free ``F.conv2d``, the card's and the JAX package's
  order (done here by replacing ``ConvBlock._block`` for the run; the
  package has no such option);
* ``float32`` and ``float64`` (the truth; ``model.double()``).

It prints, as JSON, each bf16 run's running statistics' deviation from the
float64 run and from the float32 run (largest and RMS entry), the loss of
each, and the ratio split / as computed. If the split moves the deviation to
the card's 1.7-1.8x, the double rounding explains the card; if not,
something else on the card rounds worse.

    python scripts/torch_port_bias_rounding.py [--feat-shape 128 157] [--channels 64] [--seed 0]

The defaults are the flagship's widths (Hybrid, 64 channels, pool 3,
128x157, attention 64/1/256): one step holds a few GB in float64. Smaller
``--feat-shape`` / ``--channels`` run a quick check. Imports nothing of JAX
or of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

N_WAY, K_SHOT, K_QUERY = 5, 5, 5
RUNS = ("bf16", "bf16_split_bias", "float32", "float64")


def exp_dict(compute_dtype: str) -> dict:
    """The flagship CPL train step (``chip_smoke.py``'s train phase: lr 7e-4,
    l 2.022308, M 5, T 9.2361) on the CPU at E=1."""
    return {
        "encoder_name": "Hybrid", "use_attention": True, "use_contrastive": True, "input_type": "spec",
        "specaug_params": {"use": True, "mask_param": 16, "W": 22, "num_mask": 1, "mask_value": 0, "p": 0.282},
        "train_query_augmentations": True, "lr": 7e-4, "n_training_tasks": 1, "device": "cpu",
        "loss": {"l_param": 2.022308, "cpl": {"use": True, "m_param": 5, "t_param": 9.2361},
                 "angular": {"use": False}},
        "tpu": {"episode_batch": 1, "compute_dtype": compute_dtype},
    }


def split_bias_block(self, x, update_stats=True, view_groups=None):
    """``ConvBlock._block``'s train path with the bias added by a separate
    add in the compute dtype after a bias-free conv."""
    conv, bn = self[0], self[1]
    x = F.conv2d(x, conv.weight.to(x.dtype), None, padding=1)
    x = x + conv.bias.to(x.dtype)[:, None, None]
    x = bn(x, update_stats, view_groups)
    return F.relu(F.max_pool2d(x, self.pool))


def running_stats(model) -> torch.Tensor:
    return torch.cat([b.double().ravel() for n, b in model.named_buffers()
                      if n.endswith(("running_mean", "running_var"))])


def deviation(x: torch.Tensor, ref: torch.Tensor) -> list:
    d = x - ref
    return [d.abs().max().item(), d.square().mean().sqrt().item()]


def main(argv=None) -> dict:
    from audio_few_shot_learning_tpu_torch.config import ExperimentConfig, ModelConfig
    from audio_few_shot_learning_tpu_torch.data.episodes import sample_episode
    from audio_few_shot_learning_tpu_torch.data.store import PackedStore
    from audio_few_shot_learning_tpu_torch.losses import draw_cpl_gumbel
    from audio_few_shot_learning_tpu_torch.models.dropout import Dropout
    from audio_few_shot_learning_tpu_torch.models.encoders import ConvBlock
    from audio_few_shot_learning_tpu_torch.ops.specaugment import draw_views_params
    from audio_few_shot_learning_tpu_torch.train.engine import TrainDraws, Trainer

    ap = argparse.ArgumentParser()
    ap.add_argument("--feat-shape", type=int, nargs=2, default=(128, 157))
    ap.add_argument("--channels", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    f, t = args.feat_shape
    t0 = time.perf_counter()

    rng = np.random.default_rng(args.seed)
    n_classes, per_class = 5, 10
    segments = rng.standard_normal((n_classes * per_class, f, t), dtype=np.float32)
    labels = np.repeat(np.arange(n_classes), per_class)
    store = PackedStore.from_flat_arrays(segments, np.ones(len(labels), np.int64), labels, n_classes, device="cpu")
    ep = sample_episode(torch.Generator().manual_seed(args.seed + 1), store, N_WAY, K_SHOT, K_QUERY, 1)
    g = torch.Generator().manual_seed(args.seed + 2)
    specaug = ExperimentConfig.from_dict(exp_dict("float32")).specaug_params
    draws = TrainDraws(perms=torch.rand((1, 3), generator=g).argsort(dim=-1) + 1,
                       cpl_gumbel=draw_cpl_gumbel(g, 1, N_WAY * K_QUERY, N_WAY, "cpu"))
    draws.support, draws.query = (draw_views_params(g, specaug, 1, k, f, t, "cpu")
                                  for k in (N_WAY * K_SHOT, N_WAY * K_QUERY))
    mdl = ModelConfig.from_dict({"Hybrid": {"hidden_channels": args.channels}})

    init = None
    stats, losses = {}, {}
    plain_block = ConvBlock._block
    for name in RUNS:
        dtype = {"bf16": "bfloat16", "bf16_split_bias": "bfloat16"}.get(name, name)
        trainer = Trainer(ExperimentConfig.from_dict(exp_dict(dtype)), mdl, store, seed=args.seed + 3)
        if init is None:
            init = {k: v.clone() for k, v in trainer.model.state_dict().items()}
        trainer.model.load_state_dict(init)
        if name == "float64":
            trainer.model.double()
        for m in trainer.model.modules():
            if isinstance(m, Dropout):
                m.p = 0.0
        ConvBlock._block = split_bias_block if name == "bf16_split_bias" else plain_block
        try:
            metrics = trainer.train_step(ep, draws)
        finally:
            ConvBlock._block = plain_block
        losses[name] = float(metrics[0])
        stats[name] = running_stats(trainer.model)
        del trainer

    out = {"feat_shape": [f, t], "channels": args.channels, "seed": args.seed, "loss": losses,
           "running_stats_entries": stats["float64"].numel(),
           "running_stats_scale": stats["float64"].abs().max().item()}
    for name in ("bf16", "bf16_split_bias"):
        out[f"{name}_vs_float64"] = deviation(stats[name], stats["float64"])
        out[f"{name}_vs_float32"] = deviation(stats[name], stats["float32"])
    out["float32_vs_float64"] = deviation(stats["float32"], stats["float64"])
    for ref in ("float64", "float32"):
        a, b = out[f"bf16_vs_{ref}"], out[f"bf16_split_bias_vs_{ref}"]
        out[f"split_over_fused_vs_{ref}"] = [b[0] / a[0], b[1] / a[1]]
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
