"""Optimizer and learning-rate schedule (counterpart of the JAX package's
``train/state.py``): torch's Adam with betas (0.9, 0.999) and eps 1e-8, the
reference's optimizer, under the reference's MultiStepLR as the JAX package
computes it. The JAX package runs ``optax.piecewise_constant_schedule`` over
optimizer steps with one boundary at ``m * steps_per_epoch`` per milestone
``m``: the learning rate of update ``k`` (counted from 0) is ``lr`` times
``gamma`` once for every distinct milestone with ``k >= m * steps_per_epoch``,
i.e. scaled once each milestone epoch has been completed. The step count is
the trainer's, saved and restored with a resume checkpoint.
"""

from __future__ import annotations

from typing import Iterable, Sequence

import torch


def make_optimizer(params: Iterable[torch.nn.Parameter], lr: float) -> torch.optim.Adam:
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def scheduled_lr(
    step: int, lr: float, milestones: Sequence[int], gamma: float, steps_per_epoch: int
) -> float:
    """Learning rate of optimizer update ``step`` (0-based)."""
    passed = sum(1 for m in set(int(m) for m in milestones) if step >= m * steps_per_epoch)
    return lr * gamma**passed


def param_count(module: torch.nn.Module) -> int:
    """Number of parameter entries (JAX ``param_count``, train/state.py:74).
    A model's count includes the reference's two projection LayerNorms
    (``projection_head.ln1``/``ln2``), which its forward never applies and
    the JAX package's parameter tree does not hold."""
    return sum(p.numel() for p in module.parameters())
