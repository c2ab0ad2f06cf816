"""Encoder, attention fusion, projection and the episode model: the names
the JAX package's ``models`` exports."""

from audio_few_shot_learning_tpu_torch.models.attention import SelfAttention  # noqa: F401
from audio_few_shot_learning_tpu_torch.models.encoders import (  # noqa: F401
    StandardCNN,
    StandardHybrid,
    make_backbone,
)
from audio_few_shot_learning_tpu_torch.models.projection import ProjectionHead, RelationHead  # noqa: F401
from audio_few_shot_learning_tpu_torch.models.protonets import (  # noqa: F401
    EpisodeOutputs,
    FewShotEpisodeModel,
)
