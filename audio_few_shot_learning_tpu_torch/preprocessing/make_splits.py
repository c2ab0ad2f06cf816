"""Class-split asset production (``splits.npy``) and waveform statistics.

Counterpart of the JAX package's ``preprocessing/make_splits.py``. The
reference ships per-dataset split files (``data/<ds>/splits.npy``, three
arrays of class names read at datasets/datasets.py:61-64) but no script
that makes them; this makes a seeded class partition with the reference's
per-dataset train/val/test class counts, the same partition as the JAX
package for the same classes and seed.

Reference counts: ESC-50 35/5/10 · FSD2018 29/5/7 · NSynth 705/101/200 ·
BirdClef 501/72/142 · VoxCeleb 655/96/177.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np

# (n_train, n_val, n_test) class counts per dataset
REFERENCE_SPLIT_COUNTS = {
    "esc": (35, 5, 10),
    "kaggle": (29, 5, 7),
    "fsd2018": (29, 5, 7),
    "nsynth": (705, 101, 200),
    "birdclef": (501, 72, 142),
    "voxceleb": (655, 96, 177),
}


def list_classes(features_dir: Union[str, Path]) -> list:
    """Class folder names under a features/ (or waveforms_npy/) directory."""
    features_dir = Path(features_dir)
    return sorted(d for d in os.listdir(features_dir) if (features_dir / d).is_dir())


def _resolve_counts(
    n_classes: int, counts: Optional[Tuple[int, int, int]], dataset: Optional[str]
) -> Tuple[int, int, int]:
    if counts is None:
        if dataset is None or dataset not in REFERENCE_SPLIT_COUNTS:
            raise ValueError(
                "pass counts=(n_train, n_val, n_test) or a known dataset name "
                f"({sorted(REFERENCE_SPLIT_COUNTS)})"
            )
        counts = REFERENCE_SPLIT_COUNTS[dataset]
    if sum(counts) == n_classes:
        return counts
    # another class census than the reference's (a subset, or BirdClef after
    # pruning): keep the reference's proportions, at least one class a split
    total = sum(counts)
    n_val = max(1, round(counts[1] / total * n_classes))
    n_test = max(1, round(counts[2] / total * n_classes))
    n_train = n_classes - n_val - n_test
    if n_train < 1:
        raise ValueError(f"{n_classes} classes cannot fill a train/val/test split")
    return (n_train, n_val, n_test)


def make_splits(
    features_dir: Union[str, Path],
    out_path: Union[str, Path],
    counts: Optional[Tuple[int, int, int]] = None,
    dataset: Optional[str] = None,
    seed: int = 0,
) -> np.ndarray:
    """Partition the class folders into train/val/test and write splits.npy:
    an object array of three string arrays (train, val, test class names),
    read with ``np.load(..., allow_pickle=True)[split_idx]``. The shuffle is
    seeded, so preprocessing again gives the same partition."""
    classes = list_classes(features_dir)
    n_train, n_val, n_test = _resolve_counts(len(classes), counts, dataset)

    order = np.random.default_rng(seed).permutation(len(classes))
    shuffled = [classes[i] for i in order]
    split_list = [
        np.array(shuffled[:n_train]),
        np.array(shuffled[n_train : n_train + n_val]),
        np.array(shuffled[n_train + n_val : n_train + n_val + n_test]),
    ]
    splits = np.empty(3, dtype=object)
    splits[:] = split_list

    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    np.save(out_path, splits, allow_pickle=True)
    return splits


def compute_waveform_norm(npy_dir: Union[str, Path], out_path: Union[str, Path]) -> np.ndarray:
    """Write ``waveform_norm.npy``: (2,)-shaped [mean, std] over every raw
    waveform sample (near (0, 1), since to_np_and_norm z-normalizes each file)."""
    npy_dir = Path(npy_dir)
    total, total_sq, count = 0.0, 0.0, 0
    for cls in sorted(os.listdir(npy_dir)):
        cdir = npy_dir / cls
        if not cdir.is_dir():
            continue
        for fname in os.listdir(cdir):
            if not fname.endswith(".npy"):
                continue
            x = np.load(cdir / fname).astype(np.float64)
            total += x.sum()
            total_sq += (x * x).sum()
            count += x.size
    if count == 0:
        raise ValueError(f"no .npy waveforms under {npy_dir}")
    mean = total / count
    std = float(np.sqrt(max(total_sq / count - mean * mean, 0.0)))
    stats = np.array([mean, std], dtype=np.float32)
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    np.save(out_path, stats)
    return stats
