"""Few-shot utility functions (counterpart of the JAX package's
``ops/util_functions.py``, the reference's ``models/util_functions.py``).

``compute_prototypes`` lives in ``ops/protohead.py``; here are entropy,
k-nearest neighbours, the power transform and cosine scoring (reference
``few_shot_classifier.py:118-126``). Plain tensor ops: none of them is a
kernel in the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from audio_few_shot_learning_tpu_torch.ops.protohead import pairwise_sqeuclidean


def entropy(logits: torch.Tensor) -> torch.Tensor:
    """Mean prediction entropy from logits ``[n, classes]``."""
    probs = torch.softmax(logits, dim=1)
    return torch.mean(-torch.sum(probs * torch.log(probs + 1e-12), dim=1))


def k_nearest_neighbours(features: torch.Tensor, k: int) -> torch.Tensor:
    """Indices ``[n, k]`` of the k nearest neighbours of each row, itself
    excluded: the smallest k+1 distances hold the row itself at ~0, so
    column 0 is dropped."""
    d = torch.sqrt(pairwise_sqeuclidean(features, features) + 1e-24)
    return torch.topk(-d, k + 1, dim=1).indices[:, 1:]


def power_transform(features: torch.Tensor, power_factor: float) -> torch.Tensor:
    """``(relu(x) + 1e-6) ** power_factor``."""
    return (F.relu(features) + 1e-6) ** power_factor


def cosine_scores(samples: torch.Tensor, prototypes: torch.Tensor) -> torch.Tensor:
    """Cosine-similarity logits: ``normalize(samples) @ normalize(prototypes).T``."""

    def _norm(x):
        return x / torch.linalg.vector_norm(x, dim=1, keepdim=True).clamp_min(1e-12)

    return _norm(samples) @ _norm(prototypes).T
