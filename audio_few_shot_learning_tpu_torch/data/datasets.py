"""Directory-backed datasets in the reference's on-disk layout (the PyTorch
package's counterpart of the JAX package's ``data/datasets.py``).

Layout: ``<root>/features/<class>/*.npy`` (``waveforms_npy`` for wav
input), ``<root>/splits.npy`` (three arrays of class names: train, valid,
test) and ``<root>/norm_stats/glob_norm.npy`` (the global mean and std of the
log-mel values, shape (2, 1, 1)). ``load_packed_split`` packs one split into
a device-resident ``PackedStore`` (spec features, z-scored) or
``PackedWavStore`` (raw waveforms, the z-norm applied after the mel), or
into host RAM as a ``HostStore`` / ``WavHostStore`` when ``tpu.host_store``
says so or the split would not fit on the card beside the training program
(or, for wav, passes the device store's int32 sample addressing); the
engine then streams each episode batch to the card. Spec files are packed by
the native C++ packer (``data/native_pack.py``), or through numpy with the
same arithmetic where the files are irregular. ``make_synthetic_dataset``
writes a learnable spec dataset in the same layout, and
``make_synthetic_wav_dataset`` a raw-waveform one.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from audio_few_shot_learning_tpu_torch.config import ExperimentConfig
from audio_few_shot_learning_tpu_torch.data import native_pack
from audio_few_shot_learning_tpu_torch.data.hoststore import HostStore
from audio_few_shot_learning_tpu_torch.data.store import PackedStore, resolve_store_dtype
from audio_few_shot_learning_tpu_torch.data.wavhoststore import WavHostStore
from audio_few_shot_learning_tpu_torch.data.wavstore import MAX_DEVICE_SAMPLES, PackedWavStore

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

    def _file_bytes(self, probes=None) -> int:
        """The files' total size on disk, from ``probes`` (the split's
        ``native_pack.probe_files``, made here when None)."""
        nbytes = (native_pack.probe_files(self.filepaths) if probes is None else probes)[2]
        if (nbytes < 0).any():
            raise FileNotFoundError(f"{self.filepaths[int(np.argmax(nbytes < 0))]} does not open")
        return int(nbytes.sum())

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

    def estimated_packed_bytes(self, dtype="float32", probes=None) -> int:
        """The packed split's size from the files' sizes (spec files are
        float32, scaled to the store's dtype; wav stores are float32).
        ``probes``: the split's ``native_pack.probe_files``, made here when
        None."""
        itemsize = 4 if self.input_type == "wav" else resolve_store_dtype(dtype).itemsize
        return int(self._file_bytes(probes) * itemsize / 4)

    def estimated_samples(self, probes=None) -> int:
        """An upper bound on a wav split's sample count from the files'
        sizes (float32 samples plus their headers)."""
        return self._file_bytes(probes) // 4

    def _pack_spec_native(self, dtype: torch.dtype, probes=None):
        """``(segments [G, F, T] CPU tensor, seg_counts)`` from the native
        packer, or None when the files are irregular (a header the packer
        does not take, or feature shapes that differ). ``probes``: the
        split's ``native_pack.probe_files``, made here when None."""
        if not self.filepaths:
            return None
        elems, seg_counts, _ = native_pack.probe_files(self.filepaths) if probes is None else probes
        if (elems < 0).any():
            return None
        first = np.load(self.filepaths[0], mmap_mode="r", allow_pickle=False)
        f_dim, t_dim = first.shape[-2:] if first.ndim in (2, 3) else (0, 0)
        if f_dim * t_dim == 0 or (elems != seg_counts * f_dim * t_dim).any():
            return None
        offsets = np.zeros(len(seg_counts) + 1, dtype=np.int64)
        offsets[1:] = np.cumsum(seg_counts * f_dim * t_dim)
        out = torch.empty((int(seg_counts.sum()), f_dim, t_dim), dtype=dtype)
        native_pack.pack_files_flat(self.filepaths, out, offsets, self.mean, self.std)
        return out, seg_counts

    def _pack_spec(self, dtype, probes) -> Tuple[torch.Tensor, np.ndarray]:
        """The split's z-scored segments ``[G, F, T]`` in ``dtype`` on the CPU
        and per-item segment counts: native packer, or the same arithmetic
        in numpy (``native_pack.normalize``) for irregular files."""
        dtype = resolve_store_dtype(dtype)
        if dtype in (torch.float32, torch.bfloat16):
            flat = self._pack_spec_native(dtype, probes)
            if flat is not None:
                return flat
        items = [np.load(p, allow_pickle=True) for p in self.filepaths]
        items = [native_pack.normalize(x[None] if x.ndim == 2 else x, self.mean, self.std) for x in items]
        segments = np.concatenate(items, axis=0) if items else np.zeros((0, 1, 1), np.float32)
        return torch.from_numpy(segments).to(dtype), np.asarray([x.shape[0] for x in items], np.int64)

    def to_packed_store(self, dtype="float32", device: Union[str, torch.device] = "cuda", probes=None):
        """The split on ``device``; ``probes`` as for ``_pack_spec_native``."""
        if self.input_type == "wav":
            items = [np.load(p, allow_pickle=True) for p in self.filepaths]
            return PackedWavStore.pack(
                items, self.labels, n_classes=len(self.class_names), mean=self.mean,
                std=self.std, multi_segm=self.multi_segm,
                segment_seconds=self._segment_seconds(), device=device,
            )
        segments, seg_counts = self._pack_spec(dtype, probes)
        return PackedStore.from_flat_arrays(segments, seg_counts, self.labels, len(self.class_names),
                                            device=device)

    def to_host_store(self, dtype="float32", probes=None):
        """The split in host RAM: a ``HostStore`` (spec) or a
        ``WavHostStore`` streamed from the files' headers (wav; ``dtype``
        ``'bfloat16'`` means float16 there). ``probes`` as for
        ``_pack_spec_native``."""
        if self.input_type == "wav":
            return WavHostStore.pack_from_files(
                self.filepaths, self.labels, n_classes=len(self.class_names), mean=self.mean,
                std=self.std, multi_segm=self.multi_segm, segment_seconds=self._segment_seconds(),
                dtype=dtype,
            )
        segments, seg_counts = self._pack_spec(dtype, probes)
        return HostStore.from_flat_arrays(segments, seg_counts, self.labels, len(self.class_names))


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
    """One split as a ``PackedStore`` / ``PackedWavStore`` on ``device``, or
    in host RAM as a ``HostStore`` / ``WavHostStore`` (the JAX package's
    routing): ``tpu.host_store`` true forces the host store, false the
    device store; null picks the host store when the packed split (wav
    reckoned in float32) exceeds ``HOST_STORE_MEMORY_FRACTION`` of the
    card's memory, or when a wav split's samples pass the device store's
    int32 addressing (``MAX_DEVICE_SAMPLES``). The estimate's file sizes
    come from the packer's header probe, one native call, which the pack
    then reuses."""
    device = torch.device(device)
    dtype = exp.tpu.store_dtype if dtype is None else dtype
    ds = MetaAudioDataset(exp, root, split)
    host, probes = exp.tpu.host_store, None
    if host is None:
        probes = native_pack.probe_files(ds.filepaths)
        limit = _device_memory_bytes(device)
        est = ds.estimated_packed_bytes(dtype, probes)
        host = limit is not None and est > HOST_STORE_MEMORY_FRACTION * limit
        host = host or (ds.input_type == "wav" and ds.estimated_samples(probes) >= MAX_DEVICE_SAMPLES)
    if host:
        return ds.to_host_store(dtype=dtype, probes=probes)
    return ds.to_packed_store(dtype=dtype, device=device, probes=probes)


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
    _save_splits(root, class_names, split_fractions)
    return root


def make_synthetic_wav_dataset(
    root: Union[str, Path],
    n_classes: int = 12,
    items_per_class: int = 12,
    sr: int = 16000,
    seconds: float = 2.0,
    variable_length: bool = False,
    split_fractions: Tuple[int, int, int] = (8, 2, 2),
    seed: int = 0,
) -> Path:
    """Write a raw-waveform dataset (``waveforms_npy/`` layout): per class a
    tone of its own in noise; ``norm_stats/glob_norm.npy`` holds the online
    log-mel's mean and std over the first second of two items a class, as
    the wav pipeline expects. The waveforms are the JAX package's for the
    same arguments (same generator calls in the same order); the log-mel
    runs on the CPU."""
    from audio_few_shot_learning_tpu_torch.ops.mel import MelSpec

    root = Path(root)
    rng = np.random.default_rng(seed)
    wav_dir = root / "waveforms_npy"
    wav_dir.mkdir(parents=True, exist_ok=True)
    (root / "norm_stats").mkdir(exist_ok=True)
    if sum(split_fractions) != n_classes:
        raise ValueError(f"split fractions {split_fractions} must sum to n_classes={n_classes}")
    class_names = [f"class_{i:03d}" for i in range(n_classes)]
    mel = MelSpec("online")
    mel_vals = []
    for ci, name in enumerate(class_names):
        cdir = wav_dir / name
        cdir.mkdir(exist_ok=True)
        freq = 200.0 + 300.0 * ci
        for ii in range(items_per_class):
            dur = seconds * (0.5 + rng.random() * 1.5) if variable_length else seconds
            n = int(sr * dur)
            t = np.arange(n) / sr
            x = np.sin(2 * np.pi * freq * t) + 0.3 * rng.standard_normal(n)
            x = (x / max(np.abs(x).max(), 1e-6)).astype(np.float32)
            np.save(cdir / f"item_{ii:04d}.npy", x)
            if ii < 2:  # a subsample for the statistics
                mel_vals.append(mel(torch.from_numpy(x[:sr])).numpy().ravel())

    flat = np.concatenate(mel_vals)
    glob_norm = np.array([[[flat.mean()]], [[flat.std()]]], dtype=np.float32)
    np.save(root / "norm_stats" / "glob_norm.npy", glob_norm)
    _save_splits(root, class_names, split_fractions)
    return root


def _save_splits(root: Path, class_names: List[str], split_fractions: Tuple[int, int, int]) -> None:
    """``splits.npy``: the class names of train, valid and test, in order."""
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
