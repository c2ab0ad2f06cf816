"""The Audio Spectrogram Transformer (AST) backbone.

Gong, Chung and Glass, "AST: Audio Spectrogram Transformer", Interspeech
2021 (arXiv:2104.01778); ``src/models/ast_models.py::ASTModel``, which is
timm's ``vit_deit_base_distilled_patch16_384`` with its patch embedding and
position embedding refitted to a spectrogram:

* a map ``[F, T]`` is read as AST reads ``[1, F, T]`` after its transpose;
  ``patch_embed.proj`` is ``Conv2d(1, D, patch, stride=(fstride, tstride))``,
  its ``f_dim x t_dim`` outputs flattened frequency-major into tokens;
* a ``[CLS]`` and a distillation token are prepended and a learned position
  embedding of ``f_dim * t_dim + 2`` tokens added;
* ``depth`` pre-LN blocks, ``x + Attn(LN(x))`` then ``x + MLP(LN(x))``:
  ``num_heads`` heads of ``D / num_heads``, ``qkv`` with a bias, scale
  ``head_dim^-0.5``; an MLP ``D -> mlp_dim -> D`` with the exact GELU;
  LayerNorm eps ``ln_eps``; no dropout or drop-path (AST's defaults);
* a final LayerNorm, the mean of the two prepended tokens, then ``mlp_head``
  (``LayerNorm(D)`` + ``Linear(D, out_dim)``).

Parameter names are AST's (``v.patch_embed.proj``, ``v.cls_token``,
``v.dist_token``, ``v.pos_embed``, ``v.blocks.{i}.{norm1,attn.qkv,attn.proj,
norm2,mlp.fc1,mlp.fc2}``, ``v.norm``, ``mlp_head.{0,1}``), under
``backbone.encoder`` in the episode model. timm's classifier heads
(``v.head``, ``v.head_dist``), which AST's forward never reads, are not
made.

The blocks run in ``compute_dtype`` with float32 parameters, as the conv
encoders do; ``mlp_head`` runs in float32, as their heads do. Attention is
one ``scaled_dot_product_attention`` call a block: on the card with the math
backend excluded (flash, memory-efficient or cuDNN), so no block stores its
``tokens x tokens`` scores for the backward pass. An eval forward (no grad)
runs the GELU in place and frees each block's temporaries as soon as they
are dead, so a map holds at most its residual stream, a LayerNorm output and
the MLP hidden (or q, k, v and the attention's output): that is the
encoder's ``eval_item_bytes``, which the engine's eval batch rule reckons
with. With ``remat`` each block is recomputed in the
backward pass (``torch.utils.checkpoint``). The encoder draws nothing from
the generator it is handed.

The forward runs in the span ``afsl.encoder``; the counters
``encoder.tokens`` (the tokens of the last call), ``encoder.attention_calls``
and ``encoder.fused_attention_calls`` (those with the math backend
excluded), each set once a call, are the tracing's (``utils/profiling.py``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.attention import SDPBackend, sdpa_kernel
from torch.utils.checkpoint import checkpoint

from audio_few_shot_learning_tpu_torch.config import ASTConfig
from audio_few_shot_learning_tpu_torch.models.encoders import torch_dtype
from audio_few_shot_learning_tpu_torch.utils.profiling import read_counter, set_counter, spanned

FUSED_BACKENDS = [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION, SDPBackend.CUDNN_ATTENTION]
ATTENTION_CALLS, FUSED_ATTENTION_CALLS, TOKENS = (
    "encoder.attention_calls", "encoder.fused_attention_calls", "encoder.tokens")


def patch_grid(cfg: ASTConfig, feat_shape: Tuple[int, int]) -> Tuple[int, int]:
    """``(f_dim, t_dim)``: the patches along frequency and time."""
    f, t = feat_shape
    if f < cfg.patch or t < cfg.patch:
        raise ValueError(f"a {f}x{t} map is smaller than one {cfg.patch}x{cfg.patch} patch")
    return (f - cfg.patch) // cfg.fstride + 1, (t - cfg.patch) // cfg.tstride + 1


def _count(name: str, calls: int) -> None:
    set_counter(name, (read_counter(name) or 0) + calls)


def _linear(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    return F.linear(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype))


def _layer_norm(x: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
    return F.layer_norm(x, norm.normalized_shape, norm.weight.to(x.dtype), norm.bias.to(x.dtype), norm.eps)


class PatchEmbed(nn.Module):
    def __init__(self, cfg: ASTConfig):
        super().__init__()
        self.proj = nn.Conv2d(1, cfg.embed_dim, cfg.patch, stride=(cfg.fstride, cfg.tstride))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``[B, 1, F, T]`` -> ``[B, f_dim * t_dim, D]``, frequency-major."""
        w = self.proj
        y = F.conv2d(x, w.weight.to(x.dtype), w.bias.to(x.dtype), stride=w.stride)
        return y.flatten(2).transpose(1, 2)


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"embed_dim {dim} is not a multiple of num_heads {num_heads}")
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, d = x.shape
        h = self.num_heads
        # q, k and v as views of the one qkv output: their gradients join by
        # one concatenation into qkv's layout, with no transposing copy
        q, k, v = (t.view(b, n, h, d // h).transpose(1, 2) for t in _linear(x, self.qkv).split(d, dim=-1))
        if x.is_cuda:  # a fused kernel or an error, never the math backend's stored scores
            with sdpa_kernel(FUSED_BACKENDS):
                ctx = F.scaled_dot_product_attention(q, k, v)
        else:
            ctx = F.scaled_dot_product_attention(q, k, v)
        del q, k, v  # an eval forward frees qkv before the output projection
        return _linear(ctx.transpose(1, 2).reshape(b, n, d), self.proj)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)


class Block(nn.Module):
    def __init__(self, cfg: ASTConfig):
        super().__init__()
        d = cfg.embed_dim
        self.norm1 = nn.LayerNorm(d, eps=cfg.ln_eps)
        self.attn = Attention(d, cfg.num_heads)
        self.norm2 = nn.LayerNorm(d, eps=cfg.ln_eps)
        self.mlp = Mlp(d, cfg.mlp_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(_layer_norm(x, self.norm1))
        h = _linear(_layer_norm(x, self.norm2), self.mlp.fc1)
        # in place under no grad (eval), where nothing keeps the GELU's input
        h = F.gelu(h) if torch.is_grad_enabled() else torch.ops.aten.gelu_(h)
        y = _linear(h, self.mlp.fc2)
        del h  # an eval forward frees the hidden before the residual add
        return x + y


class VisionTransformer(nn.Module):
    """AST's ``v``: the patch embedding, the two prepended tokens, the
    position embedding, the blocks and the final LayerNorm."""

    def __init__(self, cfg: ASTConfig, tokens: int):
        super().__init__()
        d = cfg.embed_dim
        self.patch_embed = PatchEmbed(cfg)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.dist_token = nn.Parameter(torch.zeros(1, 1, d))
        self.pos_embed = nn.Parameter(torch.zeros(1, tokens, d))
        self.blocks = nn.ModuleList(Block(cfg) for _ in range(cfg.depth))
        self.norm = nn.LayerNorm(d, eps=cfg.ln_eps)
        for p in (self.cls_token, self.dist_token, self.pos_embed):  # timm's init
            nn.init.trunc_normal_(p, std=0.02)


class ASTEncoder(nn.Module):
    """Spectrograms ``[B, F, T]`` -> features ``[B, out_dim]`` (float32)."""

    def __init__(self, cfg: ASTConfig, feat_shape: Tuple[int, int], compute_dtype: str = "bfloat16",
                 remat: bool = False):
        super().__init__()
        self.compute_dtype = torch_dtype(compute_dtype)
        self.remat = remat
        self.out_dim = cfg.out_dim
        f_dim, t_dim = patch_grid(cfg, feat_shape)
        self.tokens = f_dim * t_dim + 2
        # what one map holds at an eval forward's widest point: the residual
        # stream, a LayerNorm output and the MLP hidden, or the residual, a
        # LayerNorm output, q, k, v and the attention's output
        width = max(2 * cfg.embed_dim + cfg.mlp_dim, 6 * cfg.embed_dim)
        self.eval_item_bytes = self.tokens * width * self.compute_dtype.itemsize
        self.v = VisionTransformer(cfg, self.tokens)
        self.mlp_head = nn.Sequential(nn.LayerNorm(cfg.embed_dim), nn.Linear(cfg.embed_dim, cfg.out_dim))

    @spanned("afsl.encoder")
    def forward(self, x: torch.Tensor, gen: Optional[torch.Generator] = None, view_groups=None) -> torch.Tensor:
        """``gen`` and ``view_groups`` are the conv encoders' arguments; AST
        has no dropout and no BatchNorm, and takes neither."""
        v = self.v
        dt = self.compute_dtype
        b = x.shape[0]
        x = v.patch_embed(x[:, None].to(dt))
        lead = torch.cat([v.cls_token, v.dist_token], dim=1).to(dt).expand(b, -1, -1)
        x = torch.cat([lead, x], dim=1) + v.pos_embed.to(dt)
        set_counter(TOKENS, b * x.shape[1])
        recompute = self.remat and self.training and torch.is_grad_enabled()
        for block in v.blocks:
            x = checkpoint(block, x, use_reentrant=False) if recompute else block(x)
        _count(ATTENTION_CALLS, len(v.blocks))
        if x.is_cuda:  # every block's attention ran with the math backend excluded
            _count(FUSED_ATTENTION_CALLS, len(v.blocks))
        x = _layer_norm(x, v.norm)
        x = ((x[:, 0] + x[:, 1]) / 2).to(self.mlp_head[1].weight.dtype)
        return self.mlp_head(x)
