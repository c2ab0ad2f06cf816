"""Metrics logging and the episodes/s counter (the PyTorch package's own
copy of the JAX package's ``utils/logging.py`` and ``EpisodeThroughput``):
every epoch row lands in a JSONL file, optionally echoed to stdout."""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


class MetricsLogger:
    def __init__(self, path: Optional[str] = None, stdout: bool = True):
        self.path = path
        self.stdout = stdout
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._fh = open(path, "a")
        else:
            self._fh = None

    def log(self, step: int, metrics: Dict[str, Any]) -> None:
        row = {"step": step, "time": time.time(), **metrics}
        if self._fh:
            self._fh.write(json.dumps(row, default=float) + "\n")
            self._fh.flush()
        if self.stdout:
            printable = {k: (round(v, 5) if isinstance(v, float) else v) for k, v in metrics.items()}
            print(f"[step {step}] {printable}")

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None


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
