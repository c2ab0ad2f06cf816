"""Metrics logging, throughput accounting, profiling and the msgpack codec."""

from audio_few_shot_learning_tpu_torch.utils.logging import MetricsLogger  # noqa: F401
from audio_few_shot_learning_tpu_torch.utils.profiling import EpisodeThroughput, profile_trace  # noqa: F401
