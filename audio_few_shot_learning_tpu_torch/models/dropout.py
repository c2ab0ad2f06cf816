"""Dropout drawn from an explicit ``torch.Generator``.

The JAX package draws its dropout masks from the ``dropout`` key a train
step passes in; here a train step passes the trainer's generator down the
forward, so a run is reproducible from its seed and a resumed run replays
it. The global RNG is never used. ``Dropout.p`` is a plain attribute, so a
caller can set it to 0 on every such module of a model.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


def dropout(x: torch.Tensor, p: float, gen: Optional[torch.Generator]) -> torch.Tensor:
    """Zero each element with probability ``p`` and scale the kept ones by
    ``1 / (1 - p)``; the mask comes from ``gen``."""
    if p == 0.0:
        return x
    if gen is None:
        raise ValueError("train-mode dropout draws from an explicit generator; pass gen")
    keep = torch.rand(x.shape, generator=gen, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), 0.0)


class Dropout(nn.Module):
    """Dropout in train mode, the identity in eval mode."""

    def __init__(self, p: float):
        super().__init__()
        self.p = float(p)

    def forward(self, x: torch.Tensor, gen: Optional[torch.Generator] = None) -> torch.Tensor:
        return dropout(x, self.p, gen) if self.training else x

    def extra_repr(self) -> str:
        return f"p={self.p}"
