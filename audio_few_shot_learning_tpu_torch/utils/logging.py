"""Metrics logging (the PyTorch package's own copy of the JAX package's
``utils/logging.py``): every epoch row lands in a JSONL file, optionally
echoed to stdout."""

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
