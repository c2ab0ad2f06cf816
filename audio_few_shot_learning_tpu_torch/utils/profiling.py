"""Profiling: a ``torch.profiler`` trace around a block, and the
episodes/s counter (counterpart of the JAX package's ``utils/profiling.py``).

``profile_trace`` records the host's ops and, for work on the card, its
kernels and copies, and writes a Chrome trace (``*.pt.trace.json``, which
TensorBoard's profiler plugin and ``chrome://tracing`` read) into
``log_dir``. Unlike the JAX package's, which turns a trace that cannot
start or be written into a no-op, it raises: a profile that silently
records nothing would hide what the device did.
"""

from __future__ import annotations

import contextlib
import os
from typing import Optional, Union

import torch


@contextlib.contextmanager
def profile_trace(log_dir: str, enabled: bool = True, device: Union[str, torch.device, None] = None):
    """Trace the block into ``log_dir``; yields the ``torch.profiler``
    profile (None when not ``enabled``). CUDA activities are traced when
    ``device`` is a card, or, with no ``device``, when a card is present."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    os.makedirs(log_dir, exist_ok=True)  # raises where log_dir cannot be made
    cuda = torch.cuda.is_available() if device is None else torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize(device)


class EpisodeThroughput:
    """Exponentially smoothed episodes/s."""

    def __init__(self, alpha: float = 0.3):
        self.alpha = alpha
        self.value: Optional[float] = None
        self.total_episodes = 0

    def update(self, episodes: int, seconds: float) -> float:
        eps = episodes / max(seconds, 1e-9)
        self.total_episodes += episodes
        self.value = eps if self.value is None else self.alpha * eps + (1 - self.alpha) * self.value
        return self.value
