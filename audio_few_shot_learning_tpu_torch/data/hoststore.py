"""Host-resident packed store and the host episodic sampler.

Counterpart of the JAX package's ``data/hoststore.py``. The device-resident
``PackedStore`` keeps a whole split on the card; a split that does not fit
beside the training program (``data/datasets.py::load_packed_split``), or
one the config keeps on the host (``tpu.host_store: true``), stays in host
RAM here. Episodes are drawn on the host with a numpy Generator, making the
JAX package's numpy calls in its order (the reference's ``random.sample``
semantics, datasets/batch_creation.py:21-72), so one Generator gives the
same episodes in both packages, bit for bit. Only the assembled batch goes
to the card, through the engine's pinned, double-buffered staging
(``data/staging.py``); the model path after episode assembly is the device
store's.

Sampling is split in two: ``plan`` draws the items and segments (numpy, the
only randomness), ``gather`` copies their rows into a given tensor (one
``index_select`` for spectrograms, one gather of windows for waveforms), so
the engine writes each batch straight into a staging buffer.
``sample_episode_batch`` does both into fresh tensors and returns the JAX
package's six fields. The store itself is never pinned: at tens of GB that
is slow and may fail; only the staging buffers are.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from audio_few_shot_learning_tpu_torch.data.episodes import EpisodeBatch
from audio_few_shot_learning_tpu_torch.data.store import resolve_store_dtype


@dataclasses.dataclass
class HostEpisodes:
    """The items and segments of E host-sampled episodes (numpy). Query
    arrays hold ``Q * rows_per_query`` entries an episode: ``s_max`` rows per
    item, query-major, for the test episodes of a multi-segment store, else 1."""

    support_items: np.ndarray  # [E, S]
    support_segs: np.ndarray  # [E, S]
    query_items: np.ndarray  # [E, Qtot]
    query_segs: np.ndarray  # [E, Qtot], clamped to each item's last segment
    query_mask: Optional[np.ndarray]  # [E, Qtot] float32, 1 = real segment (multi-segment test only)
    n_way: int
    k_support: int
    k_query: int
    rows_per_query: int

    @property
    def batch(self) -> int:
        return self.support_items.shape[0]


def episode_labels(n_way: int, k_support: int, k_query: int, rows_per_query: int, batch: int,
                   device: Union[str, torch.device] = "cpu"):
    """(support_labels [E, S], query_labels [E, Qtot], audio_ids [E, Qtot])
    of the layout every episode of a batch shares, int64."""
    ways = torch.arange(n_way, device=device)
    qn = n_way * k_query
    return (ways.repeat_interleave(k_support).expand(batch, -1),
            ways.repeat_interleave(k_query * rows_per_query).expand(batch, -1),
            torch.arange(qn, device=device).repeat_interleave(rows_per_query).expand(batch, -1))


class HostSampler:
    """The host episodic sampler over ``class_items``, ``class_counts``,
    ``seg_counts`` and ``s_max``; a store adds ``feat_shape`` (a row's
    shape), ``dtype`` and ``gather``."""

    is_host_resident = True
    zero_padding = True  # padded multi-segment query rows are zeros (spec); wav repeats the last segment

    def _index(self, labels: np.ndarray, n_classes: int, seg_counts: np.ndarray) -> None:
        self.labels = np.asarray(labels, np.int32)
        self.n_classes = int(n_classes)
        self.seg_counts = np.asarray(seg_counts, np.int32)
        self.s_max = int(self.seg_counts.max()) if len(self.seg_counts) else 1
        self.multi_segm = self.s_max > 1
        # items per class, in the reference's dataset order (datasets/datasets.py:84-91)
        self.class_items: List[np.ndarray] = [
            np.nonzero(self.labels == c)[0].astype(np.int32) for c in range(self.n_classes)]
        self.class_counts = np.asarray([len(ci) for ci in self.class_items], np.int32)

    @property
    def num_items(self) -> int:
        return len(self.seg_counts)

    def plan(self, rng: np.random.Generator, n_way: int, k_support: int, k_query: int,
             is_test: bool = False, batch: int = 1) -> HostEpisodes:
        """E = ``batch`` episodes' items and segments, drawn with the JAX
        package's calls in its order (``HostStore._sample_one``): per episode
        ``rng.choice`` of the classes with enough items (sorted), one
        ``rng.permutation`` per class split support | query, ``rng.random``
        for the support's segments, then for the queries' unless this is a
        test episode of a multi-segment store, which takes every segment of
        each query item, padded to ``s_max``."""
        need = k_support + k_query
        eligible = np.nonzero(self.class_counts >= need)[0]
        all_rows = is_test and self.multi_segm
        rep = self.s_max if all_rows else 1
        sup_i, sup_s, qry_i, qry_s, masks = [], [], [], [], []
        for _ in range(batch):
            classes = np.sort(rng.choice(eligible, size=n_way, replace=False))
            sup_items, qry_items = [], []
            for c in classes:
                row = self.class_items[c][rng.permutation(self.class_counts[c])[:need]]
                sup_items.append(row[:k_support])
                qry_items.append(row[k_support:])
            sup_items, qry_items = np.concatenate(sup_items), np.concatenate(qry_items)
            sup_i.append(sup_items)
            sup_s.append((rng.random(len(sup_items)) * self.seg_counts[sup_items]).astype(np.int32))
            if not all_rows:
                qry_i.append(qry_items)
                qry_s.append((rng.random(len(qry_items)) * self.seg_counts[qry_items]).astype(np.int32))
                continue
            item_rep = np.repeat(qry_items, rep)
            seg_rep = np.tile(np.arange(rep, dtype=np.int32), len(qry_items))
            counts = self.seg_counts[item_rep]
            qry_i.append(item_rep)
            qry_s.append(np.minimum(seg_rep, counts - 1))
            masks.append((seg_rep < counts).astype(np.float32))
        return HostEpisodes(
            support_items=np.stack(sup_i), support_segs=np.stack(sup_s),
            query_items=np.stack(qry_i), query_segs=np.stack(qry_s),
            query_mask=np.stack(masks) if all_rows else None,
            n_way=n_way, k_support=k_support, k_query=k_query, rows_per_query=rep,
        )

    def gather(self, items: np.ndarray, segs: np.ndarray, out: torch.Tensor) -> None:
        raise NotImplementedError

    def sample_episode_batch(self, rng: np.random.Generator, n_way: int, k_support: int, k_query: int,
                             is_test: bool = False, batch: int = 1) -> EpisodeBatch:
        """E independent episodes as one CPU ``EpisodeBatch`` with the JAX
        package's six fields (rows in the store's dtype, labels int64):
        ``audio_ids`` and ``query_mask`` are set on every batch, as there."""
        p = self.plan(rng, n_way, k_support, k_query, is_test, batch)
        support = torch.empty((p.batch, p.support_items.shape[1], *self.feat_shape), dtype=self.dtype)
        query = torch.empty((p.batch, p.query_items.shape[1], *self.feat_shape), dtype=self.dtype)
        self.gather(p.support_items, p.support_segs, support)
        self.gather(p.query_items, p.query_segs, query)
        mask = torch.ones(p.query_items.shape, dtype=torch.float32)
        if p.query_mask is not None:
            mask = torch.from_numpy(p.query_mask)
            if self.zero_padding:
                query.mul_(mask.to(query.dtype).reshape(*mask.shape, *[1] * len(self.feat_shape)))
        sup_lab, qry_lab, ids = episode_labels(n_way, k_support, k_query, p.rows_per_query, p.batch)
        return EpisodeBatch(support=support, support_labels=sup_lab, query=query, query_labels=qry_lab,
                            audio_ids=ids, query_mask=mask)


class HostStore(HostSampler):
    """A packed spectrogram split in host RAM: the ``PackedStore`` layout
    (segments ``[G, F, T]`` float32 or bfloat16, a CPU tensor; per-item
    segment offsets and counts) with the host sampler."""

    def __init__(self, segments: torch.Tensor, seg_counts: np.ndarray, labels: np.ndarray, n_classes: int):
        if segments.device.type != "cpu" or not segments.is_contiguous():
            raise ValueError("a HostStore keeps its segments in one contiguous CPU tensor")
        self.segments = segments  # [G, F, T]
        self._index(labels, n_classes, seg_counts)
        self.seg_offsets = np.zeros(len(self.seg_counts), np.int64)
        if len(self.seg_counts):
            self.seg_offsets[1:] = np.cumsum(self.seg_counts, dtype=np.int64)[:-1]

    @property
    def feat_shape(self):
        return tuple(self.segments.shape[1:])

    @property
    def dtype(self) -> torch.dtype:
        return self.segments.dtype

    def nbytes(self) -> int:
        return self.segments.numel() * self.segments.element_size()

    def gather(self, items: np.ndarray, segs: np.ndarray, out: torch.Tensor) -> None:
        """Segment ``segs[...]`` of item ``items[...]`` into ``out [..., F, T]``
        (one ``index_select`` of whole rows)."""
        rows = torch.from_numpy((self.seg_offsets[items] + segs).reshape(-1))
        torch.index_select(self.segments, 0, rows, out=out.view(-1, *self.feat_shape))

    @staticmethod
    def from_flat_arrays(segments: Union[np.ndarray, torch.Tensor], seg_counts: np.ndarray,
                         labels: Sequence[int], n_classes: int,
                         dtype: Union[str, torch.dtype, None] = None) -> "HostStore":
        """A store from a flat ``[G, F, T]`` segment array and per-item
        segment counts; ``dtype`` converts the segments (default: keep)."""
        seg = torch.as_tensor(segments)
        if dtype is not None:
            seg = seg.to(resolve_store_dtype(dtype))
        return HostStore(seg.contiguous(), seg_counts, np.asarray(labels), n_classes)

    @staticmethod
    def pack(items: Sequence[np.ndarray], labels: Sequence[int], n_classes: Optional[int] = None,
             mean: float = 0.0, std: float = 1.0,
             dtype: Union[str, torch.dtype, np.dtype, type] = "float32") -> "HostStore":
        """Per-item arrays (``[F, T]`` or ``[S, F, T]``) z-scored in float32
        with ``(x - mean) / std`` and packed flat (JAX ``HostStore.pack``)."""
        labels_np = np.asarray(labels, np.int32)
        if n_classes is None:
            n_classes = int(labels_np.max()) + 1 if len(labels_np) else 0
        norm, counts = [], []
        for x in items:
            x = np.asarray(x, np.float32)
            if x.ndim == 2:
                x = x[None]
            norm.append((x - mean) / std)
            counts.append(x.shape[0])
        segments = np.concatenate(norm, axis=0) if norm else np.zeros((0, 1, 1), np.float32)
        return HostStore.from_flat_arrays(segments, np.asarray(counts, np.int32), labels_np, n_classes, dtype)
