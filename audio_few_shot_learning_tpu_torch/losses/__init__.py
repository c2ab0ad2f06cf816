"""Losses of the episodic train step: FSL prototypical cross-entropy, CPL
contrastive-prototypical and angular prototypical, each batched over a
leading episode axis."""

from audio_few_shot_learning_tpu_torch.losses.angular import angular_loss  # noqa: F401
from audio_few_shot_learning_tpu_torch.losses.cpl import cpl_loss, draw_cpl_gumbel  # noqa: F401
from audio_few_shot_learning_tpu_torch.losses.fsl import fsl_loss  # noqa: F401
