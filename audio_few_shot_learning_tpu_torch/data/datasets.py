"""Directory-backed datasets in the reference's on-disk layout (the PyTorch
package's counterpart of the JAX package's ``data/datasets.py``).

Layout: ``<root>/features/<class>/*.npy`` (``waveforms_npy`` for wav
input), ``<root>/splits.npy`` (three arrays of class names: train, valid,
test) and ``<root>/norm_stats/glob_norm.npy`` (the global mean and std of the
log-mel values, shape (2, 1, 1)). ``load_packed_split`` packs one split into
a device-resident ``PackedStore`` (spec features, z-scored) or
``PackedWavStore`` (raw waveforms, the z-norm applied after the mel) through
numpy. A split too large to sit on the card beside the training program
would need the JAX package's host-resident stores, which are a later slice
of the port: such a split raises and names them. ``make_synthetic_dataset``
writes a learnable spec dataset in the same layout.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from audio_few_shot_learning_tpu_torch.config import ExperimentConfig
from audio_few_shot_learning_tpu_torch.data.store import PackedStore, resolve_store_dtype
from audio_few_shot_learning_tpu_torch.data.wavstore import PackedWavStore

_SPLIT_IDX = {"train": 0, "valid": 1, "test": 2}
# as the JAX package: a split larger than this share of the card's memory
# belongs in a host-resident store
HOST_STORE_MEMORY_FRACTION = 0.6


class MetaAudioDataset:
    """File-backed view of one split."""

    def __init__(self, experiment_config: ExperimentConfig, root: Union[str, Path], split: str):
        self.experiment_config = experiment_config
        self.root = Path(root)
        self.split = split
        self.multi_segm = experiment_config.multi_segm
        self.input_type = experiment_config.input_type

        data_dir = self.root / ("waveforms_npy" if self.input_type == "wav" else "features")
        splits_file = np.load(self.root / "splits.npy", allow_pickle=True)
        self.class_names = [str(c) for c in splits_file[_SPLIT_IDX[split]]]
        self.class_to_label = {name: i for i, name in enumerate(self.class_names)}
        self.filepaths: List[Path] = []
        self.labels: List[int] = []
        for name in self.class_names:
            cdir = data_dir / name
            for fname in sorted(os.listdir(cdir)):
                if fname.endswith(".npy"):
                    self.filepaths.append(cdir / fname)
                    self.labels.append(self.class_to_label[name])
        self.mean, self.std = self.get_normalization_stats()

    def get_normalization_stats(self) -> Tuple[float, float]:
        norm_stats = np.load(self.root / "norm_stats" / "glob_norm.npy")
        return float(np.ravel(norm_stats[0])[0]), float(np.ravel(norm_stats[1])[0])

    def __len__(self) -> int:
        return len(self.filepaths)

    def __getitem__(self, item: int):
        x = np.load(self.filepaths[item], allow_pickle=True)
        if self.input_type == "spec":
            if x.ndim == 2:
                x = x[None]
            x = (x - self.mean) / self.std
        return x, self.labels[item]

    def _segment_seconds(self) -> int:
        # NSynth's notes are 4 s, every other dataset's window 5 s
        return 4 if "nsynth" in self.experiment_config.dataset_name.lower() else 5

    def estimated_packed_bytes(self, dtype="float32") -> int:
        """The packed split's size from the files' sizes (spec files are
        float32, scaled to the store's dtype; wav stores are float32)."""
        itemsize = 4 if self.input_type == "wav" else resolve_store_dtype(dtype).itemsize
        return int(sum(p.stat().st_size for p in self.filepaths) * itemsize / 4)

    def to_packed_store(self, dtype="float32", device: Union[str, torch.device] = "cuda"):
        items = [np.load(p, allow_pickle=True) for p in self.filepaths]
        if self.input_type == "wav":
            return PackedWavStore.pack(
                items, self.labels, n_classes=len(self.class_names), mean=self.mean,
                std=self.std, multi_segm=self.multi_segm,
                segment_seconds=self._segment_seconds(), device=device,
            )
        return PackedStore.pack(
            items, self.labels, n_classes=len(self.class_names), mean=self.mean,
            std=self.std, dtype=dtype, device=device,
        )


def _device_memory_bytes(device: torch.device) -> Optional[int]:
    if device.type != "cuda":
        return None
    return int(torch.cuda.get_device_properties(device).total_memory)


def load_packed_split(
    exp: ExperimentConfig,
    root: Union[str, Path],
    split: str,
    device: Union[str, torch.device] = "cuda",
    dtype: Optional[str] = None,
):
    """One split as a ``PackedStore`` / ``PackedWavStore`` on ``device``."""
    device = torch.device(device)
    dtype = exp.tpu.store_dtype if dtype is None else dtype
    ds = MetaAudioDataset(exp, root, split)
    limit = _device_memory_bytes(device)
    too_large = limit is not None and ds.estimated_packed_bytes(dtype) > HOST_STORE_MEMORY_FRACTION * limit
    if exp.tpu.host_store or (exp.tpu.host_store is None and too_large):
        raise NotImplementedError(
            f"the {split} split ({ds.estimated_packed_bytes(dtype) / 1e9:.1f} GB packed) needs a "
            "host-resident store (HostStore / WavHostStore), a later slice of the port"
        )
    return ds.to_packed_store(dtype=dtype, device=device)


def make_synthetic_dataset(
    root: Union[str, Path],
    n_classes: int = 12,
    items_per_class: int = 15,
    n_mels: int = 128,
    n_frames: int = 157,
    multi_segm: bool = False,
    max_segments: int = 4,
    split_fractions: Tuple[int, int, int] = (8, 2, 2),
    seed: int = 0,
    band_gain: float = 4.0,
) -> Path:
    """Write a learnable synthetic spec dataset in the reference's layout.

    Each class gets a bump of ``band_gain`` on 8 mel bands of its own, on
    top of unit noise and a per-item offset, so few-shot accuracy well above
    chance is reachable in a few epochs: 4.0 saturates 5-way accuracy,
    ~0.3-0.6 lands mid-range. The files are the JAX package's for the same
    arguments (same generator calls in the same order)."""
    root = Path(root)
    rng = np.random.default_rng(seed)
    feat_dir = root / "features"
    feat_dir.mkdir(parents=True, exist_ok=True)
    (root / "norm_stats").mkdir(exist_ok=True)
    if sum(split_fractions) != n_classes:
        raise ValueError(f"split fractions {split_fractions} must sum to n_classes={n_classes}")
    class_names = [f"class_{i:03d}" for i in range(n_classes)]

    all_vals = []
    for ci, name in enumerate(class_names):
        cdir = feat_dir / name
        cdir.mkdir(exist_ok=True)
        band = 4 + (ci * (n_mels - 20)) // max(n_classes - 1, 1)
        for ii in range(items_per_class):
            segs = rng.integers(1, max_segments + 1) if multi_segm else 1
            x = rng.standard_normal((segs, n_mels, n_frames)).astype(np.float32)
            x[:, band : band + 8, :] += band_gain  # the class's energy band
            x += rng.standard_normal((segs, 1, 1)).astype(np.float32)  # item offset
            arr = x if multi_segm else x[0]
            np.save(cdir / f"item_{ii:04d}.npy", arr)
            all_vals.append(arr)

    flat = np.concatenate([a.ravel() for a in all_vals])
    glob_norm = np.array([[[flat.mean()]], [[flat.std()]]], dtype=np.float32)
    np.save(root / "norm_stats" / "glob_norm.npy", glob_norm)

    tr, va, _ = split_fractions
    splits = np.array(
        [
            np.array(class_names[:tr], dtype=object),
            np.array(class_names[tr : tr + va], dtype=object),
            np.array(class_names[tr + va :], dtype=object),
        ],
        dtype=object,
    )
    np.save(root / "splits.npy", splits, allow_pickle=True)
    return root
