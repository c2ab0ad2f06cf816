"""Backbone encoders: the 4-block CNN and the CNN + RNN hybrid; the Audio
Spectrogram Transformer is in ``models/ast.py``.

Counterpart of the JAX package's ``models/encoders.py`` in NCHW:

* conv block = 3x3 conv (padding 1) -> BatchNorm -> max-pool(pool_dim,
  floor mode) -> ReLU. Pooling before the ReLU equals the reference's
  ReLU -> pool (max commutes with the monotone ReLU) and is the JAX
  package's order;
* StandardCNN = conv stack -> flatten ``(C, F', T')`` as the reference
  flattens NCHW (main_modules.py:113) -> Dropout(0.3) -> BatchNorm1d ->
  Linear, the head in float32. The JAX package flattens ``(F', T', C)``;
  ``train/weights.py`` permutes the head's rows between the two;
* Hybrid = conv stack -> ``[B, T', F'*C]`` sequence (F' major, as the JAX
  package flattens ``(F', C)``) -> RNN/GRU/LSTM with an input + output skip
  connection -> last timestep -> the same head.

Convolutions run in ``compute_dtype``. In train mode the conv blocks'
BatchNorm normalizes with float32 batch statistics (biased variance) and
moves its running statistics by momentum 0.1 towards the batch mean and the
unbiased variance (``BandwidthBatchNorm``); the head's BatchNorm1d follows
flax's ``nn.BatchNorm``, which puts the biased variance into its running
statistics (``HeadBatchNorm``). With ``tpu.bn_per_view_group`` the model
passes the batch's ``(S, Vs, Q, Vq)`` layout down and every BatchNorm, the
head's included, normalizes each (episode, view, support|query) group with
its own statistics in train mode (``grouped_batch_norm``). In eval mode all
apply the running statistics, the conv blocks' folded into the conv weights
when ``fold_bn_eval`` is set; on the card a folded block runs as one kernel
(``ops/convblock.py``): K4 for block 0, K5 for blocks 1-3 in bf16, both
writing channels-last maps (the encoder's output is ``[B, C, F', T']`` with
NHWC strides there). With ``remat``
each conv block is recomputed in the backward pass
(``torch.utils.checkpoint``) instead of holding its full-resolution
activations; the recompute leaves the running statistics alone, so they
move once per forward, as in the JAX package. Dropout draws from the
generator the caller passes down (``models/dropout.py``).

On a mesh of more than one rank (``mesh`` set on the module, by
``FewShotEpisodeModel.set_mesh``) train mode normalizes with the moments of
the global batch, as XLA reduces them over the JAX package's episode mesh:
each rank's count, mean and biased variance are combined across the ranks
(``mesh_batch_norm``). The recompute of a rematerialized block issues that
collective again, on every rank in the same order. The grouped path's
statistics belong to (episode, view) groups that lie on one rank, so it
issues none, nor does eval mode.

Module names follow the reference checkpoint (``backbone.encoder.
conv_encoder.{i}.{0,1}``, ``backbone.encoder.seq_layers``,
``backbone.encoder.logits.{1,2}``), so a reference ``state_dict`` loads with
``strict=True``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from audio_few_shot_learning_tpu_torch.config import ASTConfig, CNNConfig, HybridConfig
from audio_few_shot_learning_tpu_torch.models.dropout import Dropout
from audio_few_shot_learning_tpu_torch.ops import convblock
from audio_few_shot_learning_tpu_torch.ops.rnn import Recurrent
from audio_few_shot_learning_tpu_torch.parallel.mesh import CrossRankBatchNorm, EpisodeMesh

NUM_BLOCKS = 4
ViewGroups = Tuple[int, int, int, int]  # (S, Vs, Q, Vq) of a fused support-then-query batch


def torch_dtype(name: str) -> torch.dtype:
    """``"bfloat16"`` / ``"float32"`` -> the torch dtype."""
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dtype


def grouped_batch_norm(
    bn: nn.modules.batchnorm._BatchNorm,
    x: torch.Tensor,
    view_groups: ViewGroups,
    update_stats: bool = True,
) -> torch.Tensor:
    """Train-mode BatchNorm with one set of statistics per (episode, view,
    support|query) group (JAX ``BandwidthBatchNorm._grouped``,
    models/encoders.py:121-170): the reference's per-view loop feeds its
    backbone ~25-item groups. Rows of ``x [B, C, ...]`` come support-block
    first in (episode, item, view) order. Each group normalizes with its own
    float32 mean and biased variance; with ``update_stats`` the running
    statistics move once, by momentum towards the mean of the groups' means
    and of their unbiased variances. The recompute of a rematerialized block
    passes ``update_stats=False``: its ops and saved tensors are those of
    the first pass, and the statistics stay where that pass left them."""
    s, vs, q, vq = view_groups
    b, c = x.shape[:2]
    per = s * vs + q * vq
    e = b // per
    if e * per != b:
        raise ValueError(f"batch {b} incompatible with view_groups {view_groups}")
    xf = x.to(torch.float32).reshape(b, c, -1)
    spatial = xf.shape[-1]

    def stats(part, items, views):
        g = part.reshape(e, items, views, c, spatial)
        m = g.mean(dim=(1, 4))  # [E, views, C]
        return m, (g.square().mean(dim=(1, 4)) - m.square()).clamp_min(0.0)

    def rows(m, items, views):
        return m[:, None].expand(e, items, views, c).reshape(-1, c)

    sup_m, sup_v = stats(xf[: e * s * vs], s, vs)
    qry_m, qry_v = stats(xf[e * s * vs :], q, vq)
    mean_rows = torch.cat([rows(sup_m, s, vs), rows(qry_m, q, vq)])
    var_rows = torch.cat([rows(sup_v, s, vs), rows(qry_v, q, vq)])
    if update_stats:
        n_sup, n_qry = s * spatial, q * spatial
        with torch.no_grad():
            g_means = torch.cat([sup_m.reshape(-1, c), qry_m.reshape(-1, c)]).mean(0)
            g_vars = torch.cat([sup_v.reshape(-1, c) * (n_sup / max(n_sup - 1, 1)),
                                qry_v.reshape(-1, c) * (n_qry / max(n_qry - 1, 1))]).mean(0)
            bn.running_mean.mul_(1.0 - bn.momentum).add_(bn.momentum * g_means)
            bn.running_var.mul_(1.0 - bn.momentum).add_(bn.momentum * g_vars)
            bn.num_batches_tracked.add_(1)
    shape = (b, c) + (1,) * (x.dim() - 2)
    inv = (torch.rsqrt(var_rows + bn.eps) * bn.weight).reshape(shape)
    shift = bn.bias.reshape((1, c) + (1,) * (x.dim() - 2)) - mean_rows.reshape(shape) * inv
    return x * inv.to(x.dtype) + shift.to(x.dtype)


def mesh_batch_norm(
    bn: nn.modules.batchnorm._BatchNorm,
    x: torch.Tensor,
    mesh: EpisodeMesh,
    update_stats: bool,
    unbiased_running: bool,
) -> torch.Tensor:
    """Train-mode BatchNorm of this rank's rows ``x [B, C, ...]`` with the
    per-channel float32 moments of every rank's rows, differentiable across
    the ranks (``CrossRankBatchNorm``). With ``update_stats`` the running
    statistics move by momentum towards the global mean and the global
    variance, unbiased by the global count (``unbiased_running``) or biased."""
    y, mean, var, total = CrossRankBatchNorm.apply(x, bn.weight, bn.bias, mesh, bn.eps)
    if update_stats:
        with torch.no_grad():
            running_var = var * (total / (total - 1).clamp_min(1)).to(var.dtype) if unbiased_running else var
            bn.running_mean.lerp_(mean, bn.momentum)
            bn.running_var.lerp_(running_var, bn.momentum)
            bn.num_batches_tracked.add_(1)
    return y


class BandwidthBatchNorm(nn.BatchNorm2d):
    """BatchNorm of the conv blocks (momentum 0.1, eps 1e-5).

    Train: float32 batch statistics, the biased variance to normalize and
    the unbiased one into the running variance; ``update_stats=False``
    normalizes the same way and leaves the running statistics and
    ``num_batches_tracked`` alone (the recompute of a rematerialized block).
    On a mesh (``mesh`` set) the statistics are the global batch's
    (``mesh_batch_norm``). Eval: ``x * inv + shift`` with ``inv`` and
    ``shift`` computed in float32 from the running statistics and applied in
    the activation's dtype."""

    mesh: Optional[EpisodeMesh] = None

    def fold(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per-channel float32 ``(inv, shift)`` of the eval affine."""
        inv = torch.rsqrt(self.running_var + self.eps) * self.weight
        return inv, self.bias - self.running_mean * inv

    def forward(
        self, x: torch.Tensor, update_stats: bool = True, view_groups: Optional[ViewGroups] = None
    ) -> torch.Tensor:
        if self.training and view_groups is not None:
            return grouped_batch_norm(self, x, view_groups, update_stats)
        if self.training and self.mesh is not None:
            return mesh_batch_norm(self, x, self.mesh, update_stats, unbiased_running=True)
        if self.training:
            running = (self.running_mean, self.running_var)
            if update_stats:
                self.num_batches_tracked.add_(1)
            else:  # throwaway copies keep the op, and what it saves for backward, the same
                running = tuple(r.clone() for r in running)
            return F.batch_norm(x, *running, self.weight, self.bias, True, self.momentum, self.eps)
        inv, shift = self.fold()
        return x * inv.to(x.dtype)[:, None, None] + shift.to(x.dtype)[:, None, None]


class HeadBatchNorm(nn.BatchNorm1d):
    """The head's BatchNorm1d as flax's ``nn.BatchNorm(momentum=0.9)``
    computes it in float32: train mode normalizes with the biased batch
    variance and moves the running variance towards that same biased
    variance (torch's own BatchNorm1d would take the unbiased one). With
    ``view_groups`` (``tpu.bn_per_view_group``) train mode takes the grouped
    path instead, the JAX package's ``bn_grouped``; on a mesh (``mesh``
    set) the global batch's statistics (``mesh_batch_norm``)."""

    mesh: Optional[EpisodeMesh] = None

    def forward(self, x: torch.Tensor, view_groups: Optional[ViewGroups] = None) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if view_groups is not None:
            return grouped_batch_norm(self, x, view_groups)
        if self.mesh is not None:
            return mesh_batch_norm(self, x, self.mesh, update_stats=True, unbiased_running=False)
        var, mean = torch.var_mean(x, dim=0, correction=0)
        with torch.no_grad():
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
            self.num_batches_tracked.add_(1)
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias


class ConvBlock(nn.Sequential):
    """conv3x3 -> BN -> maxpool(pool, stride=pool) -> ReLU; children ``0``
    (Conv2d) and ``1`` (BN) as in the reference."""

    def __init__(
        self,
        in_channels: int,
        channels: int,
        pool: Tuple[int, int],
        fold_bn_eval: bool,
        remat: bool = False,
    ):
        super().__init__(nn.Conv2d(in_channels, channels, 3, padding=1), BandwidthBatchNorm(channels))
        self.pool = tuple(pool)
        self.fold_bn_eval = fold_bn_eval
        self.remat = remat

    def forward(self, x: torch.Tensor, view_groups: Optional[ViewGroups] = None) -> torch.Tensor:
        if not (self.remat and self.training and torch.is_grad_enabled()):
            return self._block(x, view_groups=view_groups)
        passes = []

        def run(inp):
            passes.append(None)
            # not on the recompute
            return self._block(inp, update_stats=len(passes) == 1, view_groups=view_groups)

        return checkpoint(run, x, use_reentrant=False, preserve_rng_state=False)

    def _block(
        self, x: torch.Tensor, update_stats: bool = True, view_groups: Optional[ViewGroups] = None
    ) -> torch.Tensor:
        conv, bn = self[0], self[1]
        ph, pw = self.pool
        if x.shape[2] < ph or x.shape[3] < pw:  # the conv keeps the map's size
            raise ValueError(
                f"pool {self.pool} collapses a {x.shape[2]}x{x.shape[3]} map to zero — "
                "reduce pool_dim or use longer inputs"
            )
        # eval mode on the card, with the BatchNorm folded: one kernel runs
        # the whole block and never writes the full-resolution map, K4 for
        # block 0 (one input channel), K5 for blocks 1-3 (C to C channels)
        # in bf16; a float32 eval keeps cuDNN for blocks 1-3 (the tensor
        # cores would take it as TF32). The wrappers raise on what their
        # kernel does not take
        eval_on_card = not self.training and convblock.on_card(x)
        block0_on_card = eval_on_card and x.shape[1] == 1
        blocks_on_card = eval_on_card and not block0_on_card and x.shape[1] == conv.out_channels
        if self.fold_bn_eval and not self.training:
            # eval BN is a per-channel affine and conv is linear, so
            # BN(conv(x, K, b)) == conv(x, K*inv, b*inv + shift)
            inv, shift = bn.fold()
            weight = (conv.weight * inv[:, None, None, None]).to(x.dtype)
            bias = (conv.bias * inv + shift).to(x.dtype)
            if block0_on_card:
                out = convblock.block0_cuda(x, weight, bias, self.pool)
                convblock.count_block0(True)
                return out
            if blocks_on_card and x.dtype == torch.bfloat16:
                out = convblock.blocks_cuda(x, weight, bias, self.pool)
                convblock.count_blocks(True)
                return out
            if blocks_on_card:
                convblock.count_blocks(False)
            x = F.conv2d(x, weight, bias, padding=1)
        else:
            if block0_on_card:
                convblock.count_block0(False)
            if blocks_on_card:
                convblock.count_blocks(False)
            x = F.conv2d(x, conv.weight.to(x.dtype), conv.bias.to(x.dtype), padding=1)
            x = bn(x, update_stats, view_groups)
        return F.relu(F.max_pool2d(x, (ph, pw)))


def conv_output_shape(feat_shape: Tuple[int, int], pool: Tuple[int, int]) -> Tuple[int, int]:
    """(F', T') after the four floor-mode pools."""
    f, t = feat_shape
    for _ in range(NUM_BLOCKS):
        f, t = f // pool[0], t // pool[1]
    if f == 0 or t == 0:
        raise ValueError(
            f"pool {tuple(pool)} collapses a {feat_shape[0]}x{feat_shape[1]} input to zero — "
            "reduce pool_dim or use longer inputs"
        )
    return f, t


def conv_item_bytes(channels: int, feat_shape: Tuple[int, int], dtype: torch.dtype) -> int:
    """Block 0's conv output of one map, ``channels x F x T`` in ``dtype``: what
    a map holds at the widest point of a conv encoder's eval forward
    (``eval_item_bytes``)."""
    return channels * feat_shape[0] * feat_shape[1] * dtype.itemsize


class _LogitsHead(nn.Sequential):
    """Dropout(0.3) -> BatchNorm1d -> Linear(out_dim), in float32."""

    def __init__(self, width: int, out_dim: int):
        super().__init__(Dropout(0.3), HeadBatchNorm(width), nn.Linear(width, out_dim))

    def forward(
        self, x: torch.Tensor, gen: Optional[torch.Generator] = None, view_groups: Optional[ViewGroups] = None
    ) -> torch.Tensor:
        return self[2](self[1](self[0](x, gen), view_groups))


class ConvEncoder(nn.ModuleList):
    """Four conv blocks (JAX ``ConvEncoder``, models/encoders.py:237-271), the
    reference's ``conv_encoder`` with children ``0``-``3``. Input ``[B, 1,
    F, T]`` in the compute dtype, output ``[B, C, F', T']``."""

    def __init__(self, channels: int, pool: Tuple[int, int], fold_bn_eval: bool = False, remat: bool = False):
        # the input has one channel (the JAX package's x[..., None])
        super().__init__(
            ConvBlock(1 if i == 0 else channels, channels, pool, fold_bn_eval, remat) for i in range(NUM_BLOCKS)
        )

    def forward(self, x: torch.Tensor, view_groups: Optional[ViewGroups] = None) -> torch.Tensor:
        for block in self:
            x = block(x, view_groups)
        return x


class StandardCNN(nn.Module):
    """4-block CNN -> flatten ``(C, F', T')`` -> head (JAX ``StandardCNN``,
    models/encoders.py:304-328). Input ``[B, F, T]``."""

    def __init__(
        self,
        cfg: CNNConfig,
        feat_shape: Tuple[int, int],
        compute_dtype: str = "bfloat16",
        fold_bn_eval: bool = False,
        remat: bool = False,
    ):
        super().__init__()
        self.compute_dtype = torch_dtype(compute_dtype)
        self.channels = cfg.hidden_channels
        self.out_dim = cfg.out_dim
        self.eval_item_bytes = conv_item_bytes(self.channels, feat_shape, self.compute_dtype)
        self.conv_encoder = ConvEncoder(cfg.hidden_channels, cfg.pool_dim, fold_bn_eval, remat)
        fp, tp = conv_output_shape(feat_shape, cfg.pool_dim)
        self.logits = _LogitsHead(cfg.hidden_channels * fp * tp, cfg.out_dim)

    def forward(
        self, x: torch.Tensor, gen: Optional[torch.Generator] = None, view_groups: Optional[ViewGroups] = None
    ) -> torch.Tensor:
        x = self.conv_encoder(x[:, None].to(self.compute_dtype), view_groups)
        x = x.to(self.logits[2].weight.dtype).flatten(1)  # the reference's NCHW view(B, -1)
        return self.logits(x, gen, view_groups)


class StandardHybrid(nn.Module):
    """4-block CNN -> time-major sequence -> recurrent stack with skip -> head.

    Input ``[B, F, T]``. The recurrent hidden size is the flattened conv width
    F'*C, which the skip connection needs.
    """

    def __init__(
        self,
        cfg: HybridConfig,
        feat_shape: Tuple[int, int],
        compute_dtype: str = "bfloat16",
        fold_bn_eval: bool = False,
        remat: bool = False,
    ):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = torch_dtype(compute_dtype)
        c = self.channels = cfg.hidden_channels
        self.out_dim = cfg.out_dim
        self.eval_item_bytes = conv_item_bytes(c, feat_shape, self.compute_dtype)
        self.conv_encoder = ConvEncoder(c, cfg.pool_dim, fold_bn_eval, remat)
        fp, _ = conv_output_shape(feat_shape, cfg.pool_dim)
        self.hidden = fp * c
        self.seq_layers = Recurrent(
            self.hidden, self.hidden, cfg.seq_layers, cfg.seq_type, cfg.bidirectional
        )
        self.logits = _LogitsHead(self.hidden, cfg.out_dim)

    def forward(
        self, x: torch.Tensor, gen: Optional[torch.Generator] = None, view_groups: Optional[ViewGroups] = None
    ) -> torch.Tensor:
        x = self.conv_encoder(x[:, None].to(self.compute_dtype), view_groups)
        x = x.to(self.logits[2].weight.dtype)  # the head's dtype: float32 but in a float64 reference
        b, c, fp, tp = x.shape
        seq = x.permute(0, 3, 2, 1).reshape(b, tp, fp * c)  # [B, T', (F', C)]
        out, _ = self.seq_layers(seq)
        fwd = out[..., : self.hidden]
        if self.cfg.bidirectional:
            seq_out = fwd + out[..., self.hidden :] + seq
        else:
            seq_out = fwd + seq
        return self.logits(seq_out[:, -1], gen, view_groups)


class EncoderModule(nn.Module):
    """The reference's wrapper: the encoder lives under ``backbone.encoder``."""

    def __init__(self, encoder: nn.Module):
        super().__init__()
        self.encoder = encoder

    def forward(
        self, x: torch.Tensor, gen: Optional[torch.Generator] = None, view_groups: Optional[ViewGroups] = None
    ) -> torch.Tensor:
        return self.encoder(x, gen, view_groups)


def make_backbone(
    encoder_name: str,
    cnn_cfg: CNNConfig,
    hybrid_cfg: HybridConfig,
    feat_shape: Tuple[int, int],
    compute_dtype: str = "bfloat16",
    fold_bn_eval: bool = False,
    remat: bool = False,
    ast_cfg: ASTConfig = ASTConfig(),
) -> EncoderModule:
    """The encoder ``encoder_name`` names under ``backbone.encoder``. Each
    has ``out_dim`` and ``eval_item_bytes`` (what one map holds at the
    widest point of its eval forward, which the engine's eval batch rule
    reckons with)."""
    if encoder_name == "Hybrid":
        return EncoderModule(StandardHybrid(hybrid_cfg, feat_shape, compute_dtype, fold_bn_eval, remat))
    if encoder_name == "CNN":
        return EncoderModule(StandardCNN(cnn_cfg, feat_shape, compute_dtype, fold_bn_eval, remat))
    if encoder_name == "AST":
        from audio_few_shot_learning_tpu_torch.models.ast import ASTEncoder

        return EncoderModule(ASTEncoder(ast_cfg, feat_shape, compute_dtype, remat))
    raise ValueError(f"unknown encoder {encoder_name!r}")
