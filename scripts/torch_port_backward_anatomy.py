#!/usr/bin/env python3
"""The conv stack's forward and backward in the PyTorch/CUDA port, by pool
form and norm: the port's counterpart of ``scripts/backward_anatomy.py``.

The flagship's 4-block conv stack at a train step's shape, ``[200, 1, 128,
157]`` (one episode x 50 items x 4 views), bf16 convolutions with their
bias, 64 channels, pool 3, then ReLU, over a grid of

  pool=max_pool2d   ``F.max_pool2d`` (the engine's; the JAX script's "rw",
                    ``nn.max_pool``)
  pool=reshape      a reshape to ``[B, C, F/3, 3, T/3, 3]`` and ``amax``
  pool=strided      the elementwise max of the 9 strided slices
                    ``x[..., i::3, j::3]``

  norm=bn           the engine's train-mode BatchNorm (``models/encoders.py::
                    BandwidthBatchNorm``: batch statistics, running
                    statistics moved)
  norm=affine       a per-channel scale and shift (what BatchNorm costs
                    beyond an affine)

Each cell reports the forward's ms (no gradients) and the forward +
backward's ms (``torch.autograd.grad`` of the output's float32 sum over
every parameter), CUDA events over ``--iters`` calls after a warm-up. For
the ``max_pool2d`` rows of both norms the forward + backward also runs under
``torch.profiler``: device ms by kernel family (conv, batchnorm, pool,
elementwise, reduce, copy) and by the ATen op that launched the kernels.
That is what splits the step's backward into the conv's, BatchNorm's and
the pool's.

    python3 scripts/torch_port_backward_anatomy.py [--iters 30] [--device cuda:0|cpu] [--out FILE]

Prints the card's name and power limit, a line a cell and one JSON line.
Runs on ``cuda:0`` unless given ``--device cpu`` (where no time is taken:
the CPU run checks the cells run); with no card it raises. Imports nothing
of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import functools
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "scripts"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch import nn  # noqa: E402

import _torch_port_bench_setup as bench  # noqa: E402
from audio_few_shot_learning_tpu_torch.models.encoders import BandwidthBatchNorm  # noqa: E402
from audio_few_shot_learning_tpu_torch.utils.profiling import card  # noqa: E402

B, F_BINS, T_FRAMES = 200, 128, 157  # 1 episode x (25 support + 25 queries) x 4 views
POOL = 3
CH = 64
POOLS = ("max_pool2d", "strided", "reshape")
NORMS = ("bn", "affine")
PROFILED = "max_pool2d"


def pool(x: torch.Tensor, impl: str) -> torch.Tensor:
    """Floor-mode ``POOL x POOL`` max pooling of ``[B, C, H, W]``, three ways."""
    h, w = (x.shape[2] // POOL) * POOL, (x.shape[3] // POOL) * POOL
    if impl == "max_pool2d":
        return F.max_pool2d(x, POOL)
    x = x[:, :, :h, :w]
    if impl == "reshape":
        return x.reshape(x.shape[0], x.shape[1], h // POOL, POOL, w // POOL, POOL).amax(dim=(3, 5))
    if impl == "strided":
        return functools.reduce(torch.maximum, [x[:, :, i::POOL, j::POOL] for i in range(POOL) for j in range(POOL)])
    raise ValueError(impl)


class Stack(nn.Module):
    """The JAX script's ``_Stack`` in NCHW: 4 x (conv3x3 + bias in
    ``dtype`` -> norm -> pool -> ReLU). ``k{i}`` / ``b{i}`` are the conv's
    weight ``[CH, C_in, 3, 3]`` and bias (PyTorch's default init from the
    seed); ``bn{i}`` the engine's BatchNorm, or ``s{i}`` / ``t{i}`` the
    affine's scale (ones) and shift (zeros)."""

    def __init__(self, pool_impl: str, norm: str, dtype: torch.dtype = torch.bfloat16, channels: int = 0):
        super().__init__()
        channels = channels or CH
        self.pool_impl, self.norm, self.dtype = pool_impl, norm, dtype
        for i in range(4):
            conv = nn.Conv2d(1 if i == 0 else channels, channels, 3, padding=1)
            setattr(self, f"k{i}", conv.weight)
            setattr(self, f"b{i}", conv.bias)
            if norm == "bn":
                setattr(self, f"bn{i}", BandwidthBatchNorm(channels))
            elif norm == "affine":
                setattr(self, f"s{i}", nn.Parameter(torch.ones(channels)))
                setattr(self, f"t{i}", nn.Parameter(torch.zeros(channels)))
            else:
                raise ValueError(norm)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(4):
            x = F.conv2d(x.to(self.dtype), getattr(self, f"k{i}").to(self.dtype),
                         getattr(self, f"b{i}").to(self.dtype), padding=1)
            if self.norm == "bn":
                x = getattr(self, f"bn{i}")(x)
            else:
                scale, shift = getattr(self, f"s{i}"), getattr(self, f"t{i}")
                x = x * scale.to(x.dtype)[:, None, None] + shift.to(x.dtype)[:, None, None]
            x = F.relu(pool(x, self.pool_impl))
        return x


def cell(pool_impl: str, norm: str, x: torch.Tensor, iters: int, device) -> dict:
    torch.manual_seed(0)
    module = Stack(pool_impl, norm).to(device).train()
    params = list(module.parameters())

    def fwd():
        with torch.no_grad():
            return module(x).float().sum()

    def fwd_bwd():
        return torch.autograd.grad(module(x).float().sum(), params)

    out = dict(pool=pool_impl, norm=norm, fwd_ms=bench.event_ms(fwd, iters, device),
               fwd_bwd_ms=bench.event_ms(fwd_bwd, iters, device))
    out["bwd_only_ms"] = None if out["fwd_ms"] is None else out["fwd_bwd_ms"] - out["fwd_ms"]
    out["bwd_over_fwd"] = None if out["fwd_ms"] is None else out["bwd_only_ms"] / out["fwd_ms"]
    if pool_impl == PROFILED:
        prof = bench.device_profile(fwd_bwd, 5, device)
        out.update(fwd_bwd_device_ms=prof["device_ms"], by_family=prof["by_family"], by_op=prof["by_op"],
                   by_kernel=prof["by_kernel"])
        fprof = bench.device_profile(fwd, 5, device)
        out.update(fwd_device_ms=fprof["device_ms"], fwd_by_family=fprof["by_family"])
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--device", default="cuda:0", help="cuda:N (default cuda:0) or cpu")
    ap.add_argument("--out", help="also write the JSON line to this file")
    args = ap.parse_args(argv)

    from audio_few_shot_learning_tpu_torch.device import resolve_device

    device = resolve_device(args.device)  # no card and no --device cpu raises here
    out = {"card": card()["nvidia_smi"] if device.type == "cuda" else None, "torch": torch.__version__,
           "device": device.type, "shape": [B, 1, F_BINS, T_FRAMES], "channels": CH, "cells": []}
    print(f"card: {out['card']}", flush=True)
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((B, 1, F_BINS, T_FRAMES), generator=gen).to(device)
    fmt = lambda v: "not measured" if v is None else f"{v:7.2f} ms"  # noqa: E731
    for pool_impl in POOLS:
        for norm in NORMS:
            c = cell(pool_impl, norm, x, args.iters, device)
            out["cells"].append(c)
            print(f"pool={pool_impl:10s} norm={norm:7s} fwd {fmt(c['fwd_ms'])}   fwd+bwd {fmt(c['fwd_bwd_ms'])}   "
                  f"bwd-only {fmt(c['bwd_only_ms'])}", flush=True)
            if c.get("by_family"):
                print(f"  device ms by family (fwd+bwd): {json.dumps(c['by_family'])}", flush=True)
    line = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line, flush=True)
    return out


if __name__ == "__main__":
    main()
