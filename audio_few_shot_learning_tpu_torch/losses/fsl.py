"""Few-shot classification loss (counterpart of the JAX package's
``losses/fsl.py``): log-softmax over the ``-euclidean`` scores, then the
mean negative log-likelihood of the true class."""

from __future__ import annotations

import torch


def fsl_loss(scores: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """scores ``[..., Q, N]``, labels ``[..., Q]`` ints -> ``[...]``."""
    logp = torch.log_softmax(scores, dim=-1)
    return -logp.gather(-1, labels[..., None].long()).squeeze(-1).mean(dim=-1)
