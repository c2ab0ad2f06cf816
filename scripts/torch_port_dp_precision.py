#!/usr/bin/env python3
"""How far float32 train steps of the data-parallel dry run lie from a
float64 step, on one card.

    python3 scripts/torch_port_dp_precision.py [--out build/torch_port_dp_precision.json]

Imports nothing of JAX. One flagship train step (``parallel/dryrun.py``'s
configuration at the published widths, E=8, the same weights, episodes and
draws, every dropout at p = 0) is taken four ways:

* ``one_process``: the plain Trainer (cuDNN's float32 train-mode BatchNorm);
* ``cross_rank_formula``: one process whose BatchNorms take the
  cross-rank path (``CrossRankBatchNorm`` on a mesh of one rank);
* ``two_ranks``: two ranks on the card over gloo (``dryrun._rank``);
* ``float64``: the same step in float64 on the CPU (plain versions).

It prints, per parameter, each float32 step's largest gradient deviation
from the float64 step over the parameter's scale (its largest |g|, floored
at 2% of the largest over all), and the gradient arriving at conv block 2's
output in the first two runs. Then it holds the block-2 BatchNorm's input
gradient, by the cross-rank formula and by cuDNN, on the same captured input
and output gradient, against float64.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

E = 8


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", default=os.path.join(REPO, "build", "torch_port_dp_precision.json"))
    args = parser.parse_args(argv)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_port_dp_precision: needs a CUDA device", file=sys.stderr)
        return 1
    from audio_few_shot_learning_tpu_torch.device import resolve_device
    from audio_few_shot_learning_tpu_torch.models.encoders import BandwidthBatchNorm, HeadBatchNorm
    from audio_few_shot_learning_tpu_torch.ops import cuda_build
    from audio_few_shot_learning_tpu_torch.parallel import dryrun as d
    from audio_few_shot_learning_tpu_torch.parallel.mesh import CrossRankBatchNorm, EpisodeMesh
    from audio_few_shot_learning_tpu_torch.parallel.spawn import run_ranks
    from audio_few_shot_learning_tpu_torch.train.engine import TrainDraws, Trainer

    cuda_build.build(["specaugment", "protohead", "mel"])
    dev = resolve_device("cuda:0")  # TF32 off
    ranks = run_ranks(d._rank, 2, ("flagship", E // 2, "cuda", E), backend="gloo", timeout_s=600)
    exp, mdl, _ = d.dryrun_configs("flagship", E, tasks=d.STEPS * E, eval_batch=E, device="cuda")
    store = d.dryrun_store("flagship", dev)

    # the block-2 BatchNorm (14x17 maps) of the cross-rank run: its input and output gradient
    captured = {}
    forward, backward = CrossRankBatchNorm.forward, CrossRankBatchNorm.backward

    def spy_forward(ctx, x, *rest):
        ctx.spy_x = x.detach()
        return forward(ctx, x, *rest)

    def spy_backward(ctx, grad, *rest):
        if ctx.spy_x.dim() == 4 and ctx.spy_x.shape[2] == 14:
            captured["x"], captured["g"] = ctx.spy_x.clone(), grad.detach().clone()
        return backward(ctx, grad, *rest)

    conv_out_grads = {}
    grads = {"two_ranks": ranks[0]["grads"]}
    for name in ("one_process", "cross_rank_formula"):
        trainer = Trainer(exp, mdl, store, seed=d.SEED, device=dev)
        d.no_dropout(trainer)
        init = {k: v.detach().cpu().clone() for k, v in trainer.model.state_dict().items()}
        if name == "cross_rank_formula":
            for m in trainer.model.modules():
                if isinstance(m, (BandwidthBatchNorm, HeadBatchNorm)):
                    m.mesh = EpisodeMesh(0, 1, dev)
            CrossRankBatchNorm.forward, CrossRankBatchNorm.backward = staticmethod(spy_forward), staticmethod(spy_backward)

        def on_forward(mod, inputs, output, name=name):  # the gradient at conv 2's output
            if inputs[0].requires_grad:
                inputs[0].register_hook(lambda grad: conv_out_grads.__setitem__(name, grad.detach().double().cpu()))

        hook = trainer.model.backbone.encoder.conv_encoder[2][1].register_forward_hook(on_forward)
        try:
            ep, draws = d.global_batch(trainer, E, 0)
            trainer.train_step(ep, draws)
        finally:
            hook.remove()
            CrossRankBatchNorm.forward, CrossRankBatchNorm.backward = staticmethod(forward), staticmethod(backward)
        grads[name] = d._grads(trainer.model)

    exp64, _, _ = d.dryrun_configs("flagship", E, compute_dtype="float64", tasks=d.STEPS * E, eval_batch=E, device="cpu")
    cpu = Trainer(exp64, mdl, d.dryrun_store("flagship", "cpu"), seed=d.SEED, device="cpu")
    cpu.model.double()
    cpu.model.load_state_dict(init)
    d.no_dropout(cpu)
    to64 = lambda t: t.cpu().double() if t.is_floating_point() else t.cpu()  # noqa: E731
    cpu.train_step(type(ep)(**{k: None if v is None else to64(v) for k, v in vars(ep).items()}),
                   TrainDraws(support=tuple(x.cpu() for x in draws.support), query=tuple(x.cpu() for x in draws.query),
                              perms=draws.perms.cpu(), cpl_gumbel=to64(draws.cpl_gumbel)))
    g64 = d._grads(cpu.model)
    scale_all = max(float(np.abs(v).max()) for v in g64.values())
    per_leaf = {}
    for n, v in g64.items():
        if n.startswith("backbone.encoder.conv_encoder.") and n.endswith(".0.bias"):
            continue  # zero but for rounding: a BatchNorm removes a conv bias's mean
        scale = max(float(np.abs(v).max()), d.SCALE_FLOOR * scale_all)
        per_leaf[n] = {k: float(np.abs(grads[k][n] - v).max()) / scale for k in ("one_process", "cross_rank_formula", "two_ranks")}

    bn = {}
    x, g = captured["x"], captured["g"]
    for dtype, name in ((torch.float32, "cudnn"), (torch.float64, "float64")):
        xx = x.to(dtype).clone().requires_grad_(True)
        BandwidthBatchNorm(x.shape[1]).to(dev, dtype).train()(xx).backward(g.to(dtype))
        bn[name] = xx.grad.double()
    xx = x.clone().requires_grad_(True)
    ref = BandwidthBatchNorm(x.shape[1]).to(dev).train()
    ref.mesh = EpisodeMesh(0, 1, dev)
    ref(xx).backward(g)
    bn["cross_rank_formula"] = xx.grad.double()
    top = bn["float64"].abs().max()
    result = dict(
        card=torch.cuda.get_device_name(0), episodes=E,
        worst={part: {k: max(names, key=lambda n: per_leaf[n][k]) for k in ("one_process", "cross_rank_formula", "two_ranks")}
               for part, names in (("conv_blocks", [n for n in per_leaf if ".conv_encoder." in n]),
                                   ("after_the_pools", [n for n in per_leaf if ".conv_encoder." not in n]))},
        per_leaf=per_leaf,
        conv2_output_grad_rel_diff=float((conv_out_grads["one_process"] - conv_out_grads["cross_rank_formula"]).abs().max()
                                         / conv_out_grads["one_process"].abs().max()),
        bn2_input_grad_rel_to_float64={k: float((bn[k] - bn["float64"]).abs().max() / top) for k in ("cudnn", "cross_rank_formula")},
    )
    for part, worst in result["worst"].items():
        for k, n in worst.items():
            print(f"{part}, {k}: worst {n} {per_leaf[n]}")
    print(json.dumps({k: v for k, v in result.items() if k != "per_leaf"}))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
