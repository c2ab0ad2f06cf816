"""Projection head and relation head (counterpart of the JAX package's
``models/projection.py``).

ProjectionHead: Linear -> ReLU -> Linear -> L2 normalize (eps 1e-12, as
``F.normalize``). The reference defines two LayerNorms, ``ln1`` and
``ln2``, that its forward never applies; they are kept here, unused, so the
reference ``state_dict`` loads with ``strict=True``.

RelationHead: the reference's config schema reserves a ``Relation`` block
and a ``relation_head`` flag (README.md:417-424) but ships no
implementation, so no reference checkpoint has a layout for it. As in the
JAX package, it is an MLP over ``[query ; prototype]`` pairs: three
Linear + ReLU layers (``hidden_dim1..3``, 256, 128, 256) and a Linear to
``out_dim`` (1). Its input width is twice the fused feature width (flax
infers it; ``Relation.input_dim`` is not read), its children are ``fc1``,
``fc2``, ``fc3`` and ``out``.
"""

from __future__ import annotations

import torch
from torch import nn

from audio_few_shot_learning_tpu_torch.config import ProjectionConfig, RelationConfig


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


class RelationHead(nn.Module):
    def __init__(self, cfg: RelationConfig, input_dim: int):
        super().__init__()
        self.fc1 = nn.Linear(input_dim, cfg.hidden_dim1)
        self.fc2 = nn.Linear(cfg.hidden_dim1, cfg.hidden_dim2)
        self.fc3 = nn.Linear(cfg.hidden_dim2, cfg.hidden_dim3)
        self.out = nn.Linear(cfg.hidden_dim3, cfg.out_dim)

    def forward(self, pairs: torch.Tensor) -> torch.Tensor:
        x = pairs
        for fc in (self.fc1, self.fc2, self.fc3):
            x = torch.relu(fc(x))
        return self.out(x)
