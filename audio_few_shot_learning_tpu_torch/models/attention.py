"""Self-attention view fusion.

Counterpart of the JAX package's ``models/attention.py``: one post-norm
``TransformerEncoderLayer`` (multi-head self-attention, then a ReLU FFN,
each with a residual and LayerNorm eps 1e-5) over the V view tokens, then
the tokens concatenated into one ``[B, V*D]`` vector. Written out as
explicit matmuls and a softmax with scale ``1/sqrt(dh)``; parameter names
follow torch's layer (``self_attn.in_proj_weight``, ``self_attn.out_proj``,
``linear1``, ``linear2``, ``norm1``, ``norm2``) under
``attention_model.encoder_layer``, as in the reference checkpoint.

In train mode dropout at ``cfg.dropout`` acts where the JAX package's does:
on the attention weights, after ``out_proj``, after the FFN's ReLU and after
``linear2``, each mask drawn from the generator the caller passes.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from audio_few_shot_learning_tpu_torch.config import AttentionConfig
from audio_few_shot_learning_tpu_torch.models.dropout import Dropout


class MultiheadSelfAttention(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError("embed_dim must divide num_heads")
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim))
        self.out_proj = nn.Linear(embed_dim, embed_dim)
        self.dropout = Dropout(dropout)  # on the attention weights
        # torch MultiheadAttention's init
        nn.init.xavier_uniform_(self.in_proj_weight)
        nn.init.zeros_(self.out_proj.bias)

    def forward(self, x: torch.Tensor, gen: Optional[torch.Generator] = None) -> torch.Tensor:
        b, v, d = x.shape
        h = self.num_heads
        dh = d // h
        q, k, vv = F.linear(x, self.in_proj_weight, self.in_proj_bias).chunk(3, dim=-1)
        q, k, vv = (t.reshape(b, v, h, dh).transpose(1, 2) for t in (q, k, vv))
        attn = self.dropout(torch.softmax((q @ k.transpose(-1, -2)) / math.sqrt(dh), dim=-1), gen)
        ctx = (attn @ vv).transpose(1, 2).reshape(b, v, d)
        return self.out_proj(ctx)


class TransformerEncoderLayer(nn.Module):
    """Post-norm (``norm_first=False``) encoder layer."""

    def __init__(self, cfg: AttentionConfig):
        super().__init__()
        d = cfg.embed_dim
        self.self_attn = MultiheadSelfAttention(d, cfg.num_heads, cfg.dropout)
        self.linear1 = nn.Linear(d, cfg.ffn_dim)
        self.linear2 = nn.Linear(cfg.ffn_dim, d)
        self.norm1 = nn.LayerNorm(d, eps=1e-5)
        self.norm2 = nn.LayerNorm(d, eps=1e-5)
        self.dropout = Dropout(cfg.dropout)  # after the FFN's ReLU
        self.dropout1 = Dropout(cfg.dropout)  # after out_proj
        self.dropout2 = Dropout(cfg.dropout)  # after linear2

    def forward(self, x: torch.Tensor, gen: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.norm1(x + self.dropout1(self.self_attn(x, gen), gen))
        y = self.linear2(self.dropout(F.relu(self.linear1(x)), gen))
        return self.norm2(x + self.dropout2(y, gen))


class SelfAttention(nn.Module):
    def __init__(self, cfg: AttentionConfig):
        super().__init__()
        self.encoder_layer = TransformerEncoderLayer(cfg)

    def forward(self, x: torch.Tensor, gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """x: [B, V, D] view tokens -> [B, V*D] fused features."""
        b, v, d = x.shape
        return self.encoder_layer(x, gen).reshape(b, v * d)
