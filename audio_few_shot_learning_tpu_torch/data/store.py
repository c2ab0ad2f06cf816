"""Packed spectrogram store, resident on the device.

Counterpart of the JAX package's ``data/store.py``. A whole split is packed
once into device tensors; episode assembly is indexing, so the card never
waits on the host.

Layout (flat, no padding):
  segments     [G, F, T]   all segments of all items, concatenated
  seg_offsets  [I]         start row of item i's segments
  seg_counts   [I]         segments per item (>= 1)
  labels       [I]         class ids 0..C-1
  class_table  [C, M_max]  item indices per class (padded)
  class_counts [C]         real items per class

The flat layout matters for the variable-length datasets: a BirdClef item
holds 1-36 segments, and a padded ``[I, S_max, F, T]`` array would be
several times the data. ``dtype="bfloat16"`` halves the footprint; compute upcasts per op. Index
tensors are int64 (torch's native index type).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import numpy as np
import torch

from audio_few_shot_learning_tpu_torch.models.encoders import torch_dtype


def resolve_store_dtype(dtype: Union[str, torch.dtype, np.dtype, type]) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        return torch_dtype(dtype)
    return torch_dtype(np.dtype(dtype).name)


@dataclasses.dataclass
class PackedStore:
    segments: torch.Tensor
    seg_offsets: torch.Tensor
    seg_counts: torch.Tensor
    labels: torch.Tensor
    class_table: torch.Tensor
    class_counts: torch.Tensor
    n_classes: int
    s_max: int
    multi_segm: bool

    @property
    def num_items(self) -> int:
        return self.seg_offsets.shape[0]

    @property
    def feat_shape(self):
        return tuple(self.segments.shape[1:])

    @property
    def device(self) -> torch.device:
        return self.segments.device

    def get_segment(self, item: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
        """Segment ``seg`` of item ``item`` (any matching shapes ``[...]``) -> ``[..., F, T]``."""
        return self.segments[self.seg_offsets[item] + seg]

    def item_segment_rows(self, item: torch.Tensor, s_max: int) -> torch.Tensor:
        """Rows of the first ``s_max`` segments of each item (``[...]`` ->
        ``[..., s_max]``), clipped to the item's last real segment; mask
        with ``seg_counts`` downstream."""
        seg = torch.arange(s_max, device=item.device)
        return self.seg_offsets[item][..., None] + torch.minimum(seg, self.seg_counts[item][..., None] - 1)

    @staticmethod
    def from_flat_arrays(
        segments: Union[np.ndarray, torch.Tensor],
        seg_counts: np.ndarray,
        labels: np.ndarray,
        n_classes: int,
        device: Union[str, torch.device] = "cuda",
        dtype: Union[str, torch.dtype, None] = None,
    ) -> "PackedStore":
        """Build a store from a flat ``[G, F, T]`` segment array and per-item
        segment counts. ``dtype`` converts the segments (default: keep)."""
        labels_np = np.asarray(labels, dtype=np.int64)
        seg_counts_np = np.asarray(seg_counts, dtype=np.int64)
        offsets = np.zeros(len(seg_counts_np), dtype=np.int64)
        if len(seg_counts_np):
            offsets[1:] = np.cumsum(seg_counts_np)[:-1]

        counts = np.bincount(labels_np, minlength=n_classes).astype(np.int64)
        m_max = int(counts.max()) if len(counts) else 1
        table = np.zeros((n_classes, m_max), dtype=np.int64)
        fill = np.zeros(n_classes, dtype=np.int64)
        for idx, lab in enumerate(labels_np):
            table[lab, fill[lab]] = idx
            fill[lab] += 1

        seg = torch.as_tensor(segments)
        seg = seg.to(device=device, dtype=resolve_store_dtype(dtype) if dtype else seg.dtype)
        put = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
        s_max = int(seg_counts_np.max()) if len(seg_counts_np) else 1
        return PackedStore(
            segments=seg,
            seg_offsets=put(offsets),
            seg_counts=put(seg_counts_np),
            labels=put(labels_np),
            class_table=put(table),
            class_counts=put(counts),
            n_classes=n_classes,
            s_max=s_max,
            multi_segm=s_max > 1,
        )

    @staticmethod
    def pack(
        items: Sequence[np.ndarray],
        labels: Sequence[int],
        n_classes: Optional[int] = None,
        mean: float = 0.0,
        std: float = 1.0,
        dtype: Union[str, torch.dtype, np.dtype, type] = "float32",
        device: Union[str, torch.device] = "cuda",
    ) -> "PackedStore":
        """Pack per-item arrays (``[F, T]`` or ``[S, F, T]``) into one flat
        store, z-scored with the dataset's global ``(mean, std)``."""
        labels_np = np.asarray(labels, dtype=np.int64)
        if n_classes is None:
            n_classes = int(labels_np.max()) + 1 if len(labels_np) else 0
        norm_items, seg_counts = [], []
        for x in items:
            x = np.asarray(x, dtype=np.float32)
            if x.ndim == 2:
                x = x[None]
            norm_items.append((x - mean) / std)
            seg_counts.append(x.shape[0])
        segments = (
            np.concatenate(norm_items, axis=0) if norm_items else np.zeros((0, 1, 1), np.float32)
        )
        return PackedStore.from_flat_arrays(
            segments, np.asarray(seg_counts), labels_np, n_classes, device=device,
            dtype=resolve_store_dtype(dtype),
        )
