"""Prototypical-network episode model.

Counterpart of the JAX package's ``models/protonets.py``: encode every
(episode, item, view) in one backbone pass over support then query, fuse
the views (attention, or the views stacked view-major when attention is
off), then prototypes and ``-euclidean`` scores through the fused episode
head (K2 on the card). Takes a batch of E episodes ``[E, S, V, F, T]``; a
single episode ``[S, V, F, T]`` is the E=1 case.

With ``with_contrastive`` (the training forward of contrastive configs) it
also returns what the CPL/APL losses take: the class-mean prototypes
(``compute_prototypes``, a one-hot matmul, as the JAX package computes them
outside its kernel), the projected query features and the projected
prototypes. With attention the query views are shuffled first, the original
view kept first, by ``shuffle_perm`` ``[E, V-1]`` (a permutation of views
1..V-1 per episode, given as data), then fused again and projected.

With ``relation_head`` the scores are the relation MLP's logits over
``[query ; prototype]`` pairs instead (JAX ``protonets.py:165-179``), the
prototypes still one-hot class means; K2 does not run. With
``tpu.bn_per_view_group`` the backbone's BatchNorms get the batch's
``(S, Vs, Q, Vq)`` layout (JAX ``protonets.py:137-141``). On a mesh of
more than one rank (``set_mesh``) its train-mode BatchNorms take the
moments of the global batch.

Children are named as the reference model (``backbone``,
``attention_model``, ``projection_head``), so its ``state_dict`` loads with
``strict=True``; ``relation_head`` has no reference layout.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from audio_few_shot_learning_tpu_torch.config import ExperimentConfig, ModelConfig
from audio_few_shot_learning_tpu_torch.models.attention import SelfAttention
from audio_few_shot_learning_tpu_torch.models.encoders import BandwidthBatchNorm, HeadBatchNorm, make_backbone
from audio_few_shot_learning_tpu_torch.models.projection import ProjectionHead, RelationHead
from audio_few_shot_learning_tpu_torch.ops.protohead import batched_episode_scores, compute_prototypes
from audio_few_shot_learning_tpu_torch.ops.specaugment import NUM_VIEWS
from audio_few_shot_learning_tpu_torch.parallel.mesh import EpisodeMesh


@dataclasses.dataclass
class EpisodeOutputs:
    """With attention the feature dim is V*embed_dim and support rows are S;
    without, the feature dim is the encoder's out_dim and rows are S*V
    (view-major; query labels are tiled xV by the caller). The contrastive
    fields are None unless the forward ran ``with_contrastive``."""

    support_features: torch.Tensor  # [E, S(*V), D]
    query_features: torch.Tensor  # [E, Q(*V), D]
    scores: torch.Tensor  # [E, Q(*V), N] = -euclidean distance
    prototypes: Optional[torch.Tensor] = None  # [E, N, D]
    cpl_features: Optional[torch.Tensor] = None  # [E, Q(*V), P]
    cpl_prototypes_projected: Optional[torch.Tensor] = None  # [E, N, P]


class FewShotEpisodeModel(nn.Module):
    def __init__(self, exp: ExperimentConfig, mdl: ModelConfig, feat_shape: Tuple[int, int]):
        super().__init__()
        self.exp = exp
        self.backbone = make_backbone(
            exp.encoder_name,
            mdl.cnn,
            mdl.hybrid,
            feat_shape,
            compute_dtype=exp.tpu.compute_dtype,
            fold_bn_eval=exp.tpu.fold_bn_eval,
            remat=exp.tpu.remat_enabled(),
            ast_cfg=mdl.ast,
        )
        if exp.use_attention:
            self.attention_model = SelfAttention(mdl.attention)
        # the projection reads the fused features (V views of embed_dim) or,
        # without attention, the encoder's; flax infers this width in the
        # JAX package, so ``Projection.input_dim`` is not read
        if exp.input_type == "spec":
            views = NUM_VIEWS if exp.specaug_params.use else 1
        else:
            views = 1 + exp.waveaug_params.aug_num if exp.waveaug_params.use else 1
        width = views * mdl.attention.embed_dim if exp.use_attention else self.backbone.encoder.out_dim
        self.projection_head = ProjectionHead(dataclasses.replace(mdl.projection, input_dim=width))
        if exp.relation_head:
            self.relation_head = RelationHead(mdl.relation, 2 * width)

    def set_mesh(self, mesh: Optional[EpisodeMesh]) -> None:
        """Hand ``mesh`` to every BatchNorm; one rank (or None) keeps the
        single-process path."""
        for m in self.modules():
            if isinstance(m, (BandwidthBatchNorm, HeadBatchNorm)):
                m.mesh = mesh if mesh is not None and mesh.world > 1 else None

    def forward(
        self,
        support_views: torch.Tensor,
        query_views: torch.Tensor,
        support_labels: torch.Tensor,
        n_way: int,
        shuffle_perm: Optional[torch.Tensor] = None,
        with_contrastive: bool = False,
        gen: Optional[torch.Generator] = None,
    ) -> EpisodeOutputs:
        """``gen`` feeds the dropout masks in train mode."""
        single = support_views.dim() == 4
        if single:
            support_views, query_views = support_views[None], query_views[None]
            support_labels = support_labels[None]
            if shuffle_perm is not None:
                shuffle_perm = shuffle_perm[None]

        e, s, vs, f, t = support_views.shape
        q, vq = query_views.shape[1:3]
        if self.exp.use_attention and vs != vq:
            raise ValueError(
                "use_attention requires equal support/query view counts "
                f"(got {vs} vs {vq}) — enable query augmentations"
            )

        flat = torch.cat(
            [support_views.reshape(e * s * vs, f, t), query_views.reshape(e * q * vq, f, t)]
        )
        view_groups = (s, vs, q, vq) if self.exp.tpu.bn_per_view_group else None
        feats = self.backbone(flat, gen, view_groups).to(self.projection_head.fc1.weight.dtype)  # float32
        sup_f = feats[: e * s * vs].reshape(e, s, vs, -1)
        qry_f = feats[e * s * vs :].reshape(e, q, vq, -1)
        d = feats.shape[-1]

        if self.exp.use_attention:
            fused = self.attention_model(
                torch.cat([sup_f, qry_f], dim=1).reshape(e * (s + q), vs, d), gen
            ).reshape(e, s + q, vs * d)
            support_features, query_features = fused[:, :s], fused[:, s:]
            labels = support_labels
        else:
            support_features = sup_f.transpose(1, 2).reshape(e, s * vs, d)
            query_features = qry_f.transpose(1, 2).reshape(e, q * vq, d)
            labels = support_labels.repeat(1, vs)

        if self.exp.relation_head:
            protos = compute_prototypes(support_features, labels, n_way)
            qn = query_features.shape[1]
            pairs = torch.cat([
                query_features[:, :, None].expand(e, qn, n_way, query_features.shape[-1]),
                protos[:, None].expand(e, qn, n_way, protos.shape[-1]),
            ], dim=-1)
            scores = self.relation_head(pairs)[..., 0]  # [E, Q, N] relation logits
        else:
            protos = None
            scores = batched_episode_scores(support_features, labels, query_features, n_way)
        out = EpisodeOutputs(
            support_features=support_features, query_features=query_features, scores=scores,
            prototypes=protos,
        )
        if with_contrastive:
            if out.prototypes is None:
                out.prototypes = compute_prototypes(support_features, labels, n_way)
            if self.exp.use_attention:
                if shuffle_perm is None:
                    shuffle_perm = torch.arange(1, vq, device=qry_f.device).expand(e, vq - 1)
                first = torch.zeros((e, 1), dtype=shuffle_perm.dtype, device=shuffle_perm.device)
                idx = torch.cat([first, shuffle_perm], dim=1).long()  # the original stays first
                shuffled = qry_f.gather(2, idx[:, None, :, None].expand(e, q, vq, d))
                cpl_in = self.attention_model(shuffled.reshape(e * q, vq, d), gen)
                out.cpl_features = self.projection_head(cpl_in).reshape(e, q, -1)
            else:
                out.cpl_features = self.projection_head(query_features)
            out.cpl_prototypes_projected = self.projection_head(out.prototypes)
        if single:
            out = EpisodeOutputs(**{
                f.name: None if getattr(out, f.name) is None else getattr(out, f.name)[0]
                for f in dataclasses.fields(out)
            })
        return out
