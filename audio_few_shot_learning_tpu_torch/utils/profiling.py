"""Profiling: a ``torch.profiler`` trace around a block, the episodes/s
counter (counterpart of the JAX package's ``utils/profiling.py``), the
kernels' launch counts per call of a method (``launches_per_call``), and
what a measurement script records beside its numbers (``card``, the card's
name and power limit; ``rss_gb``, the process's peak resident set).

``profile_trace`` records the host's ops and, for work on the card, its
kernels and copies, and writes a Chrome trace (``*.pt.trace.json``, which
TensorBoard's profiler plugin and ``chrome://tracing`` read) into
``log_dir``. Unlike the JAX package's, which turns a trace that cannot
start or be written into a no-op, it raises: a profile that silently
records nothing would hide what the device did.
"""

from __future__ import annotations

import collections
import contextlib
import os
import resource
import subprocess
from typing import Dict, List, Optional, Union

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


def kernel_counters() -> tuple:
    """The wrappers of K1 (SpecAugment views), K2 (episode scores) and K3
    (mel + log); each counts its kernel's launches in ``.launches``."""
    from audio_few_shot_learning_tpu_torch.ops import mel, protohead, specaugment

    return specaugment.views_cuda, protohead.episode_scores_cuda, mel.mel_log_cuda


def tally_launches(rows: List[List[int]]) -> Dict[str, int]:
    """``{"K1 K2 K3": calls}``: how many recorded calls launched each
    pattern of K1, K2, K3 launches."""
    return {" ".join(map(str, k)): n for k, n in collections.Counter(map(tuple, rows)).items()}


@contextlib.contextmanager
def launches_per_call(owner, name: str, out: List[List[int]]):
    """While the block runs, each call of ``owner.name`` (a method of a
    class, e.g. ``Trainer.train_step``) appends the K1, K2, K3 launches it
    made to ``out``, read off the counters around the call."""
    counters = kernel_counters()
    fn = getattr(owner, name)

    def counted(*args, **kwargs):
        before = [k.launches for k in counters]
        result = fn(*args, **kwargs)
        out.append([k.launches - b for k, b in zip(counters, before)])
        return result

    setattr(owner, name, counted)
    try:
        yield out
    finally:
        setattr(owner, name, fn)


def card() -> dict:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` gives them."""
    try:
        line = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=30, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return {"nvidia_smi": None, "error": str(e)}
    return {"nvidia_smi": line.splitlines()[0] if line else line}


def rss_gb() -> float:
    """Peak resident set of this process so far, GB (``ru_maxrss`` is KiB)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
