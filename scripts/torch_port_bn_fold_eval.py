#!/usr/bin/env python3
"""Folded against unfolded eval BatchNorm through the 4-block conv stack in
the PyTorch/CUDA port: the port's counterpart of ``scripts/bn_fold_eval.py``.

Eval-mode BatchNorm is ``y = x * inv + shift`` with per-channel constants,
and the conv is linear, so ``BN(conv(x, K, b)) == conv(x, K * inv, b * inv +
shift)`` (the engine folds it when ``tpu.fold_bn_eval`` is set,
``models/encoders.py::ConvBlock``). ``stack`` is the JAX script's
``_stack`` in NCHW: per block conv3x3 with its bias, then (unfolded) the
affine, then max-pool 3 and ReLU, in bf16 at ``[200, 1, 128, 157]``, the
weights drawn from ``default_rng(0)`` as the JAX script draws them. This
reports each arm's ms (CUDA events over ``--iters`` calls after a warm-up),
their ratio, the largest deviation between the two outputs, and each arm's
device time under ``torch.profiler`` by the ATen op that launched the
kernels: the conv (``cudnn_convolution``), the conv's bias (a separate
``add_`` after cuDNN's conv), the affine's ``mul`` and ``add``, the pool and
the ReLU.

    python3 scripts/torch_port_bn_fold_eval.py [--iters 50] [--device cuda:0|cpu] [--out FILE]

Prints the card's name and power limit and one JSON line. Runs on
``cuda:0`` unless given ``--device cpu`` (where no time is taken); with no
card it raises. Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "scripts"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import _torch_port_bench_setup as bench  # noqa: E402
from audio_few_shot_learning_tpu_torch.utils.profiling import card  # noqa: E402

SHAPE = (200, 128, 157)  # the block-0 shape that dominates: 200 maps
CH = 64


def weights(cin: int = 1, channels: int = 0):
    """The JAX script's weights, the same draws from ``default_rng(0)``
    after its input ``[B, F, T, 1]``: per block a kernel ``[3, 3, C_in, CH]
    * 0.05`` (HWIO), a bias, the affine's ``inv`` in [0.8, 1.2) and its
    ``shift``; returned as the input (NCHW, float32) and float32 tensors with
    the kernels in OIHW."""
    channels = channels or CH
    rng = np.random.default_rng(0)
    b, f, t = SHAPE
    x = rng.standard_normal((b, f, t, 1))
    kernels, biases, invs, shifts = [], [], [], []
    for _ in range(4):
        k = (rng.standard_normal((3, 3, cin, channels)) * 0.05).astype(np.float32)
        kernels.append(torch.from_numpy(k.transpose(3, 2, 0, 1).copy()))
        biases.append(torch.from_numpy((rng.standard_normal(channels) * 0.05).astype(np.float32)))
        invs.append(torch.from_numpy(rng.uniform(0.8, 1.2, channels).astype(np.float32)))
        shifts.append(torch.from_numpy((rng.standard_normal(channels) * 0.05).astype(np.float32)))
        cin = channels
    return torch.from_numpy(x.transpose(0, 3, 1, 2).astype(np.float32)), (kernels, biases, invs, shifts)


def stack(x: torch.Tensor, kernels, biases, invs, shifts, folded: bool) -> torch.Tensor:
    """4-block eval forward in ``x``'s dtype: conv3x3 -> [affine] ->
    max-pool 3 -> ReLU (the JAX ``_stack``)."""
    for k, b, inv, shift in zip(kernels, biases, invs, shifts):
        if folded:
            x = F.conv2d(x, (k * inv[:, None, None, None]).to(x.dtype), (b * inv + shift).to(x.dtype), padding=1)
        else:
            x = F.conv2d(x, k.to(x.dtype), b.to(x.dtype), padding=1)
            x = x * inv.to(x.dtype)[:, None, None] + shift.to(x.dtype)[:, None, None]
        x = F.relu(F.max_pool2d(x, 3))
    return x


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--device", default="cuda:0", help="cuda:N (default cuda:0) or cpu")
    ap.add_argument("--out", help="also write the JSON line to this file")
    args = ap.parse_args(argv)

    from audio_few_shot_learning_tpu_torch.device import resolve_device

    device = resolve_device(args.device)  # no card and no --device cpu raises here
    x, params = weights()
    x = x.to(device=device, dtype=torch.bfloat16)
    params = [[p.to(device) for p in group] for group in params]
    arms = {"unfolded": lambda: stack(x, *params, folded=False), "folded": lambda: stack(x, *params, folded=True)}
    out = {"card": card()["nvidia_smi"] if device.type == "cuda" else None, "torch": torch.__version__,
           "device": device.type, "shape": [SHAPE[0], 1, SHAPE[1], SHAPE[2]], "dtype": "bfloat16"}
    print(f"card: {out['card']}", flush=True)
    with torch.inference_mode():
        for name, fn in arms.items():
            prof = bench.device_profile(fn, 5, device)
            out[name] = dict(ms=bench.event_ms(fn, args.iters, device), device_ms=prof["device_ms"],
                             by_op=prof["by_op"], by_family=prof["by_family"], by_kernel=prof["by_kernel"])
        dev = (arms["unfolded"]().float() - arms["folded"]().float()).abs().max().item()
    out["max_abs_dev"] = dev
    out["output_max_abs"] = arms["unfolded"]().float().abs().max().item()
    ms_u, ms_f = out["unfolded"]["ms"], out["folded"]["ms"]
    out["speedup"] = None if ms_f is None else ms_u / ms_f
    if ms_f is not None:
        print(f"eval 4-block stack  unfolded (conv+affine): {ms_u:7.3f} ms", flush=True)
        print(f"eval 4-block stack  folded (conv only)    : {ms_f:7.3f} ms", flush=True)
        print(f"speedup: {ms_u / ms_f:5.2f}x   max|dev|={dev:.2e} (bf16 rounding)", flush=True)
    line = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line, flush=True)
    return out


if __name__ == "__main__":
    main()
