"""Projection head (counterpart of the JAX package's ``models/projection.py``).

Linear -> ReLU -> Linear -> L2 normalize (eps 1e-12, as ``F.normalize``).
The reference defines two LayerNorms, ``ln1`` and ``ln2``, that its forward
never applies; they are kept here, unused, so the reference ``state_dict``
loads with ``strict=True``. The relation head is a later slice.
"""

from __future__ import annotations

import torch
from torch import nn

from audio_few_shot_learning_tpu_torch.config import ProjectionConfig


class ProjectionHead(nn.Module):
    def __init__(self, cfg: ProjectionConfig):
        super().__init__()
        self.fc1 = nn.Linear(cfg.input_dim, cfg.hidden_dim)
        self.fc2 = nn.Linear(cfg.hidden_dim, cfg.output_dim)
        self.ln1 = nn.LayerNorm(cfg.hidden_dim)
        self.ln2 = nn.LayerNorm(cfg.output_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.fc2(torch.relu(self.fc1(x)))
        return x / x.norm(dim=-1, keepdim=True).clamp_min(1e-12)
