"""Global normalization statistics.

Counterpart of the JAX package's ``preprocessing/norm_stats.py``: writes
``norm_stats/glob_norm.npy``, shape (2, 1, 1) = [[mean]], [[std]] of all
log-mel values, the format the reference ships per dataset and reads at
datasets/datasets.py:60-64.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Union

import numpy as np


def compute_global_norm(features_dir: Union[str, Path], out_path: Union[str, Path]) -> np.ndarray:
    """Streaming mean/std over every value of every feature file."""
    features_dir = Path(features_dir)
    total, total_sq, count = 0.0, 0.0, 0
    for cls in sorted(os.listdir(features_dir)):
        cdir = features_dir / cls
        if not cdir.is_dir():
            continue
        for fname in os.listdir(cdir):
            if not fname.endswith(".npy"):
                continue
            x = np.load(cdir / fname).astype(np.float64)
            total += x.sum()
            total_sq += (x * x).sum()
            count += x.size
    mean = total / count
    std = np.sqrt(max(total_sq / count - mean * mean, 0.0))
    glob = np.array([[[mean]], [[std]]], dtype=np.float32)
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    np.save(out_path, glob)
    return glob
