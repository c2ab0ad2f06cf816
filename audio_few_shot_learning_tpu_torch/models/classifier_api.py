"""Stateful few-shot classifier API, the reference's class surface
(counterpart of the JAX package's ``models/classifier_api.py``; reference
``models/few_shot_classifier.py:13-148``, ``models/prototypical.py:15-126``).

Code written against the reference's ``process_support_set`` /
``forward`` / ``contrastive_forward`` protocol gets the same protocol here:
a thin stateful wrapper that holds a ``FewShotEpisodeModel`` (eval mode, on
one device) and the processed support set.

Class names match the reference:
  * PrototypicalNetworks                              (prototypical.py:15-43)
  * ContrastivePrototypicalNetworks                   (prototypical.py:46-93)
  * ContrastivePrototypicalNetworksWithoutAttention   (prototypical.py:96-126)

The model is built on the first call, with ``feat_shape`` the views' last
two dims (the CNN head's width depends on it): from the ``state_dict``
given to the constructor, or else initialised from ``generator``. Views are
``[B, V, F, T]`` (V = 1 when unaugmented). Each encode call runs the
model's forward on a one-row dummy episode, as the JAX package does, so it
launches the episode head (K2) once; prototypes and scores then come from
the plain ``compute_prototypes`` / ``prototype_scores``, which the JAX
package computes outside its kernel too.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from audio_few_shot_learning_tpu_torch.config import ExperimentConfig, ModelConfig
from audio_few_shot_learning_tpu_torch.device import config_device
from audio_few_shot_learning_tpu_torch.models.protonets import FewShotEpisodeModel
from audio_few_shot_learning_tpu_torch.ops.protohead import compute_prototypes, prototype_scores
from audio_few_shot_learning_tpu_torch.ops.util_functions import cosine_scores

ArrayLike = Union[np.ndarray, torch.Tensor]


class FewShotClassifier:
    """Store the support set -> prototypes; score queries by -euclidean (or
    cosine) distance to them. Optional softmax output, feature centering
    and p-norm feature normalization (few_shot_classifier.py:18-48,96-126).

    ``device``: the card unless the caller or the config asks for the CPU,
    as the engine's entry points."""

    def __init__(
        self,
        exp: ExperimentConfig,
        mdl: ModelConfig,
        state_dict: Optional[Dict[str, torch.Tensor]] = None,
        generator: Optional[torch.Generator] = None,
        use_softmax: bool = False,
        feature_centering: Optional[ArrayLike] = None,
        feature_normalization: Optional[float] = None,
        device: Union[str, torch.device, None] = None,
    ):
        self.exp = exp
        self.mdl = mdl
        self.device = config_device(exp, device)
        self.use_softmax = use_softmax
        self.feature_centering = (
            None if feature_centering is None
            else torch.as_tensor(feature_centering, dtype=torch.float32, device=self.device)
        )
        self.feature_normalization = feature_normalization
        self.prototypes: Optional[torch.Tensor] = None
        self.support_features: Optional[torch.Tensor] = None
        self.support_labels: Optional[torch.Tensor] = None
        self._n_way: Optional[int] = None
        self.model: Optional[FewShotEpisodeModel] = None
        self._state_dict = state_dict
        self._generator = torch.Generator().manual_seed(0) if generator is None else generator

    def _views(self, views: ArrayLike) -> torch.Tensor:
        views = torch.as_tensor(views, dtype=torch.float32, device=self.device)
        if self.model is None:
            feat_shape = tuple(views.shape[-2:])
            if self._state_dict is None:
                seed = int(torch.randint(0, 2**62, (1,), generator=self._generator, device=self._generator.device))
                with torch.random.fork_rng(devices=[]):  # the model is built on the CPU
                    torch.default_generator.manual_seed(seed)
                    model = FewShotEpisodeModel(self.exp, self.mdl, feat_shape)
            else:
                model = FewShotEpisodeModel(self.exp, self.mdl, feat_shape)
                model.load_state_dict(self._state_dict, strict=True)
            self.model = model.to(self.device).eval()
        return views

    def _labels(self, labels: ArrayLike) -> torch.Tensor:
        return torch.as_tensor(labels, device=self.device).long()

    # -- feature plumbing ----------------------------------------------------

    def _postprocess(self, feats: torch.Tensor) -> torch.Tensor:
        if self.feature_centering is not None:
            feats = feats - self.feature_centering
        if self.feature_normalization is not None:
            norm = torch.linalg.vector_norm(feats, ord=self.feature_normalization, dim=1, keepdim=True)
            feats = feats / norm.clamp_min(1e-12)
        return feats

    # -- reference protocol ----------------------------------------------------

    @torch.inference_mode()
    def process_support_set(self, support_views: ArrayLike, support_labels: ArrayLike) -> None:
        """support_views ``[S, V, F, T]``, support_labels ``[S]``."""
        views = self._views(support_views)
        labels = self._labels(support_labels)
        n_way = int(labels.max()) + 1
        outs = self.model(views, views[:1], labels, n_way)
        feats = self._postprocess(outs.support_features)
        if not self.exp.use_attention:  # features are view-major S*V rows
            labels = labels.repeat(views.shape[1])
        self.support_features = feats
        self.support_labels = labels
        self.prototypes = compute_prototypes(feats, labels, n_way)
        self._n_way = n_way

    @torch.inference_mode()
    def compute_query_features(self, query_views: ArrayLike) -> torch.Tensor:
        views = self._views(query_views)
        zero = torch.zeros((1,), dtype=torch.long, device=self.device)
        return self._postprocess(self.model(views[:1], views, zero, 1).query_features)

    def l2_distance_to_prototypes(self, samples: torch.Tensor) -> torch.Tensor:
        return prototype_scores(samples, self.prototypes)

    def cosine_distance_to_prototypes(self, samples: torch.Tensor) -> torch.Tensor:
        return cosine_scores(samples, self.prototypes)

    def softmax_if_specified(self, output: torch.Tensor, temperature: float = 1.0) -> torch.Tensor:
        return torch.softmax(temperature * output, dim=-1) if self.use_softmax else output

    def __call__(self, query_views: ArrayLike, inference: bool = False) -> torch.Tensor:
        feats = self.compute_query_features(query_views)
        if inference:
            return self.softmax_if_specified(self.l2_distance_to_prototypes(feats))
        return feats

    @staticmethod
    def is_transductive() -> bool:
        return False


class PrototypicalNetworks(FewShotClassifier):
    """Plain ProtoNet: a call returns softmax-able -cdist scores
    (prototypical.py:26-43)."""

    def __call__(self, query_views: ArrayLike, inference: bool = True) -> torch.Tensor:
        feats = self.compute_query_features(query_views)
        return self.softmax_if_specified(self.l2_distance_to_prototypes(feats))


class ContrastivePrototypicalNetworks(FewShotClassifier):
    """Attention-fusion variant with contrastive_forward
    (prototypical.py:46-93)."""

    @torch.inference_mode()
    def contrastive_forward(
        self,
        query_views: ArrayLike,
        project_prototypes: bool,
        perm: Optional[ArrayLike] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Projected query features of the views shuffled by ``perm`` (a
        permutation of views 1..V-1, the original view kept first), and the
        prototypes, projected if ``project_prototypes``. Without ``perm``
        the permutation is drawn from ``generator``, or is the identity."""
        views = self._views(query_views)
        v = views.shape[1]
        if perm is None:
            perm = (torch.arange(1, v) if generator is None
                    else torch.randperm(v - 1, generator=generator, device=generator.device) + 1)
        perm = torch.as_tensor(perm, device=self.device).long()
        zero = torch.zeros((1,), dtype=torch.long, device=self.device)
        outs = self.model(views[:1], views, zero, 1, shuffle_perm=perm, with_contrastive=True)
        protos = self.model.projection_head(self.prototypes) if project_prototypes else self.prototypes
        return outs.cpl_features, protos


class ContrastivePrototypicalNetworksWithoutAttention(ContrastivePrototypicalNetworks):
    """Batch-concat variant (prototypical.py:96-126); support labels are
    tiled xV as loops/loops.py:33-37 does."""
