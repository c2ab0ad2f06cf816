"""Metrics logging and throughput accounting."""

from audio_few_shot_learning_tpu_torch.utils.logging import EpisodeThroughput, MetricsLogger  # noqa: F401
