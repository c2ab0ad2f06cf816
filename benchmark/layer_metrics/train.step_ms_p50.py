"""Median device milliseconds a train step over the untraced window: CUDA
events recorded before each ``Trainer.train_step`` call."""

import statistics


def read(record):
    ms = record.get("unit_ms")
    return statistics.median(ms) if ms else None
