"""Packed waveform store for ``input_type='wav'`` configs, resident on the device.

Counterpart of the JAX package's ``data/wavstore.py``. Waveforms are packed
once into a flat ragged layout; a segment is a slice of it, with the
reference's segmentation semantics (datasets/batch_creation.py:173-209):

  * len < seg_len  -> 1 segment = tile(sample)[:seg_len]
  * tail remainder -> segment = tile(whole sample)[:seg_len], which for an
    item with len >= seg_len is its first seg_len samples

Layout:
  waveforms [total]        all samples of all items, concatenated (at least
                           seg_len long)
  offsets   [I]            start sample of item i
  lengths   [I]            true length of item i
  tails     [T, seg_len]   tile(sample)[:seg_len] of each item shorter than
                           seg_len (one placeholder row when there is none)
  tail_index [I]           row in ``tails`` (0 when unused)

``waveforms`` and ``tails`` are two views of one buffer, so a batch of
segments is one gather of rows from a sliding-window view of it
(``extract_segment``). Single-segment stores take ``seg_len`` = the longest
item (batch_creation.py:83-84). ``mean``/``std`` are the dataset's global
statistics, applied after the mel. Index tensors are int64 (torch's native
index type).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import numpy as np
import torch

from audio_few_shot_learning_tpu_torch.config import SAMPLE_RATE, SEGMENT_SECONDS

# as the JAX package: the device store addresses samples with int32; a
# larger split is for the host-resident WavHostStore (int64 offsets)
MAX_DEVICE_SAMPLES = int(np.iinfo(np.int32).max)


def pack_wav_ragged(
    waveforms: Sequence[np.ndarray],
    multi_segm: bool,
    segment_seconds: int = SEGMENT_SECONDS,
    sr: int = SAMPLE_RATE,
):
    """Host-side ragged pack.

    Returns ``(flat [total] f32, offsets [I] i64, lengths [I] i32,
    tails [T, seg_len] f32, tail_index [I] i32, seg_counts [I] i32,
    seg_len)`` with the reference's segmentation semantics baked into the
    precomputed tail rows (see module doc).
    """
    lengths = np.asarray([w.shape[0] for w in waveforms], dtype=np.int64)
    l_max = int(lengths.max()) if len(lengths) else segment_seconds * sr
    # non-multi-segment wav datasets use the whole (fixed-length) waveform
    # (batch_creation.py:83-84: reshape(1,-1), no segmentation)
    seg_len = segment_seconds * sr if multi_segm else l_max

    offsets = np.zeros(len(lengths), dtype=np.int64)
    if len(lengths):
        offsets[1:] = np.cumsum(lengths)[:-1]
    # at least one segment long, so a seg_len slice always exists
    flat = np.zeros(max(int(lengths.sum()), seg_len), dtype=np.float32)
    # Tail rows: the repeat/tail semantics (tile the WHOLE sample,
    # batch_creation.py:201-208) only ever apply to an item's last segment,
    # and for items with len >= seg_len that is the item's flat prefix; only
    # short items need a stored row.
    tail_rows = []
    tail_index = np.zeros(len(lengths), dtype=np.int32)
    for i, w in enumerate(waveforms):
        w = np.asarray(w, dtype=np.float32)
        flat[offsets[i] : offsets[i] + w.shape[0]] = w
        if w.shape[0] == 0:
            # an empty item gets its own silent row (tail_index 0 would
            # alias another short item's audio)
            tail_index[i] = len(tail_rows)
            tail_rows.append(np.zeros(seg_len, dtype=np.float32))
        elif w.shape[0] < seg_len:
            reps = -(-seg_len // w.shape[0])  # ceil
            tail_index[i] = len(tail_rows)
            tail_rows.append(np.tile(w, reps)[:seg_len])
    tails = np.stack(tail_rows) if tail_rows else np.zeros((1, seg_len), dtype=np.float32)

    if multi_segm:
        # ceil(len/seg_len); short samples get exactly 1 (repeat-padded)
        seg_counts = np.maximum(-(-lengths // seg_len), 1).astype(np.int32)
    else:
        seg_counts = np.ones(len(lengths), dtype=np.int32)
    return flat, offsets, lengths.astype(np.int32), tails, tail_index, seg_counts, seg_len


def build_class_table(labels_np: np.ndarray, n_classes: int):
    """[C, M_max] item-index table + [C] counts (reference dataset order,
    datasets/datasets.py:84-91)."""
    counts = np.bincount(labels_np, minlength=n_classes).astype(np.int64)
    m_max = int(counts.max()) if len(counts) else 1
    table = np.zeros((n_classes, m_max), dtype=np.int64)
    fill = np.zeros(n_classes, dtype=np.int64)
    for idx, lab in enumerate(labels_np):
        table[lab, fill[lab]] = idx
        fill[lab] += 1
    return table, counts


@dataclasses.dataclass
class PackedWavStore:
    buffer: torch.Tensor  # [total + T*seg_len]: waveforms, then the tail rows
    n_samples: int  # total: length of the waveforms part
    offsets: torch.Tensor  # [I] start sample of item i
    tail_index: torch.Tensor  # [I] row in ``tails``
    lengths: torch.Tensor  # [I] true lengths
    seg_counts: torch.Tensor  # [I] (1 for single-segment stores)
    labels: torch.Tensor  # [I]
    class_table: torch.Tensor  # [C, M_max]
    class_counts: torch.Tensor  # [C]
    mean: float  # global normalization, applied after the mel
    std: float
    n_classes: int
    s_max: int
    multi_segm: bool
    seg_len: int

    @property
    def waveforms(self) -> torch.Tensor:
        return self.buffer[: self.n_samples]

    @property
    def tails(self) -> torch.Tensor:
        return self.buffer[self.n_samples :].view(-1, self.seg_len)

    @property
    def num_items(self) -> int:
        return self.offsets.shape[0]

    @property
    def feat_shape(self):
        return (self.seg_len,)

    @property
    def device(self) -> torch.device:
        return self.buffer.device

    def nbytes(self) -> int:
        return self.buffer.numel() * self.buffer.element_size()

    @staticmethod
    def pack(
        waveforms: Sequence[np.ndarray],
        labels: Sequence[int],
        n_classes: Optional[int] = None,
        mean: float = 0.0,
        std: float = 1.0,
        multi_segm: bool = False,
        segment_seconds: int = SEGMENT_SECONDS,
        sr: int = SAMPLE_RATE,
        device: Union[str, torch.device] = "cuda",
    ) -> "PackedWavStore":
        labels_np = np.asarray(labels, dtype=np.int64)
        if n_classes is None:
            n_classes = int(labels_np.max()) + 1 if len(labels_np) else 0

        flat, offsets, lengths, tails, tail_index, seg_counts, seg_len = pack_wav_ragged(
            waveforms, multi_segm, segment_seconds, sr
        )
        if flat.shape[0] >= MAX_DEVICE_SAMPLES - seg_len:
            # a split this large (> ~8.6 GB f32) is for the host store
            raise ValueError(
                f"split has {flat.shape[0]} samples (> int32 addressing); such a split is for the "
                "host-resident WavHostStore, where load_packed_split sends it when tpu.host_store "
                "is null (or true)"
            )
        s_max = int(seg_counts.max()) if len(lengths) else 1
        table, counts = build_class_table(labels_np, n_classes)

        put = lambda a: torch.from_numpy(np.asarray(a, np.int64)).to(device)  # noqa: E731
        return PackedWavStore(
            buffer=torch.from_numpy(np.concatenate([flat, tails.reshape(-1)])).to(device),
            n_samples=flat.shape[0],
            offsets=put(offsets),
            tail_index=put(tail_index),
            lengths=put(lengths),
            seg_counts=put(seg_counts),
            labels=put(labels_np),
            class_table=put(table),
            class_counts=put(counts),
            mean=float(mean),
            std=float(std),
            n_classes=n_classes,
            s_max=s_max,
            multi_segm=multi_segm,
            seg_len=seg_len,
        )

    def extract_segment(self, item: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
        """Segment ``seg`` of item ``item`` (matching shapes ``[...]``) ->
        ``[..., seg_len]``, with the reference's repeat/tail semantics.

        A full segment starts at ``offsets[item] + seg*seg_len``; otherwise
        the tail is the item's prefix (len >= seg_len) or its ``tails`` row.
        All three are rows of one sliding-window view of ``buffer``, so the
        batch is a single gather of contiguous rows.
        """
        length = self.lengths[item]
        start = seg * self.seg_len
        off = self.offsets[item]
        full = (length - start) >= self.seg_len
        tail_row = self.n_samples + self.tail_index[item] * self.seg_len
        base = torch.where(full, off + start, torch.where(length < self.seg_len, tail_row, off))
        windows = self.buffer.unfold(0, self.seg_len, 1)  # [len(buffer) - seg_len + 1, seg_len]
        return windows[base]
