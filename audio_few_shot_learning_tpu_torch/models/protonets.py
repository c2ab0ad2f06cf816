"""Prototypical-network episode model (eval forward).

Counterpart of the JAX package's ``models/protonets.py``: encode every
(episode, item, view) in one backbone pass over support then query, fuse
the views (attention, or the views stacked view-major when attention is
off), then prototypes and ``-euclidean`` scores through the fused episode
head (K2 on the card). Takes a batch of E episodes ``[E, S, V, F, T]``; a
single episode ``[S, V, F, T]`` is the E=1 case.

Children are named as the reference model (``backbone``,
``attention_model``, ``projection_head``), so its ``state_dict`` loads with
``strict=True``. The contrastive branch, the relation head and training mode
come with later slices.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch import nn

from audio_few_shot_learning_tpu_torch.config import ExperimentConfig, ModelConfig
from audio_few_shot_learning_tpu_torch.models.attention import SelfAttention
from audio_few_shot_learning_tpu_torch.models.encoders import make_backbone
from audio_few_shot_learning_tpu_torch.models.projection import ProjectionHead
from audio_few_shot_learning_tpu_torch.ops.protohead import batched_episode_scores


@dataclasses.dataclass
class EpisodeOutputs:
    """With attention the feature dim is V*embed_dim and support rows are S;
    without, the feature dim is the encoder's out_dim and rows are S*V
    (view-major; query labels are tiled xV by the caller). The prototypes
    stay inside the fused head; the contrastive slice will expose them."""

    support_features: torch.Tensor  # [E, S(*V), D]
    query_features: torch.Tensor  # [E, Q(*V), D]
    scores: torch.Tensor  # [E, Q(*V), N] = -euclidean distance


class FewShotEpisodeModel(nn.Module):
    def __init__(self, exp: ExperimentConfig, mdl: ModelConfig, feat_shape: Tuple[int, int]):
        super().__init__()
        if exp.relation_head:
            raise NotImplementedError("the relation head is a later slice of the port")
        self.exp = exp
        self.backbone = make_backbone(
            exp.encoder_name,
            mdl.cnn,
            mdl.hybrid,
            feat_shape,
            compute_dtype=exp.tpu.compute_dtype,
            fold_bn_eval=exp.tpu.fold_bn_eval,
        )
        if exp.use_attention:
            self.attention_model = SelfAttention(mdl.attention)
        self.projection_head = ProjectionHead(mdl.projection)

    def forward(
        self,
        support_views: torch.Tensor,
        query_views: torch.Tensor,
        support_labels: torch.Tensor,
        n_way: int,
    ) -> EpisodeOutputs:
        single = support_views.dim() == 4
        if single:
            support_views, query_views = support_views[None], query_views[None]
            support_labels = support_labels[None]

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
        feats = self.backbone(flat).to(torch.float32)
        sup_f = feats[: e * s * vs].reshape(e, s, vs, -1)
        qry_f = feats[e * s * vs :].reshape(e, q, vq, -1)
        d = feats.shape[-1]

        if self.exp.use_attention:
            fused = self.attention_model(
                torch.cat([sup_f, qry_f], dim=1).reshape(e * (s + q), vs, d)
            ).reshape(e, s + q, vs * d)
            support_features, query_features = fused[:, :s], fused[:, s:]
            labels = support_labels
        else:
            support_features = sup_f.transpose(1, 2).reshape(e, s * vs, d)
            query_features = qry_f.transpose(1, 2).reshape(e, q * vq, d)
            labels = support_labels.repeat(1, vs)

        out = EpisodeOutputs(
            support_features=support_features,
            query_features=query_features,
            scores=batched_episode_scores(support_features, labels, query_features, n_way),
        )
        if single:
            out = EpisodeOutputs(
                **{f.name: getattr(out, f.name)[0] for f in dataclasses.fields(out)}
            )
        return out
