"""Packed stores (device-resident and host-resident), the episodic samplers,
the host-to-card staging and the reference-layout dataset loader."""

from audio_few_shot_learning_tpu_torch.data.hoststore import HostStore  # noqa: F401
from audio_few_shot_learning_tpu_torch.data.wavhoststore import WavHostStore  # noqa: F401
