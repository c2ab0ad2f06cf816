"""Pinned, double-buffered staging of host-sampled episode batches.

The engine's host-fed paths (``train/engine.py``) draw a batch's items on
the host (``HostSampler.plan``), gather its rows straight into a staging
buffer and copy it to the card while the card still runs the previous step.

* Two slots, each a set of grow-only buffers (support rows, query rows, the
  multi-segment mask), sized for the largest batch the run has asked for;
  a smaller batch takes a prefix. On the card they are pinned, so the copy
  is a DMA that runs beside the compute.
* The copy is issued on a stream of its own: on the compute stream it would
  queue behind the previous step's kernels and serialise the two. The
  compute stream waits for it on an event, and ``record_stream`` tells the
  caching allocator that the copied tensors are used there.
* A slot is refilled only after the event recorded behind its last copy has
  completed (``Event.synchronize``): otherwise the host would overwrite a
  batch still in flight. With two slots that wait is on the copy issued one
  step earlier, which is done by the time the host comes back to it.
* After the copy, on the compute stream: the padded rows of a multi-segment
  spectrogram batch are zeroed (the JAX package's invariant), and float16
  waveforms are upcast to float32 (the same values).
* Labels and audio ids are the same for every batch of a layout, so they are
  made on the device once per layout and never copied.

On the CPU (``device="cpu"``) nothing is pinned and nothing is copied: the
batch is used where it was gathered. Apart from the slot waits above,
nothing here synchronizes with the host.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from audio_few_shot_learning_tpu_torch.data.episodes import EpisodeBatch
from audio_few_shot_learning_tpu_torch.data.hoststore import HostEpisodes, HostSampler, episode_labels
from audio_few_shot_learning_tpu_torch.utils.profiling import spanned


class _Slot:
    def __init__(self):
        self.buffers: Dict[str, torch.Tensor] = {}
        self.done: Optional[torch.cuda.Event] = None  # recorded behind the slot's last copy

    def buffer(self, name: str, shape: Tuple[int, ...], dtype: torch.dtype, pin: bool) -> torch.Tensor:
        need = int(np.prod(shape))
        buf = self.buffers.get(name)
        if buf is None or buf.dtype != dtype or buf.numel() < need:
            buf = torch.empty(need, dtype=dtype, pin_memory=pin)
            self.buffers[name] = buf
        return buf[:need].view(shape)


class EpisodeStager:
    """Stages host-sampled batches onto ``device`` through two pinned slots
    and a copy stream. ``h2d_bytes`` counts the bytes copied to the card;
    with ``trace`` a list, each copy appends ``(start, end, bytes)``, its
    CUDA events on the copy stream."""

    def __init__(self, device: Union[str, torch.device]):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.stream = torch.cuda.Stream(self.device) if self.cuda else None
        self._slots = [_Slot(), _Slot()]
        self._turn = 0
        self._labels: Dict[tuple, tuple] = {}
        self.h2d_bytes = 0
        self.trace: Optional[List[tuple]] = None

    def _layout(self, p: HostEpisodes):
        key = (p.n_way, p.k_support, p.k_query, p.rows_per_query, p.batch)
        if key not in self._labels:
            self._labels[key] = episode_labels(*key, device=self.device)
        return self._labels[key]

    @spanned("afsl.staging")
    def stage(self, store: HostSampler, p: HostEpisodes) -> EpisodeBatch:
        """``p``'s episodes from ``store`` as an ``EpisodeBatch`` on the
        device, ready for the compute stream. Multi-segment test batches
        carry ``audio_ids`` and ``query_mask``, others leave them None."""
        with torch.inference_mode(False), torch.no_grad():  # buffers outlive an eval run
            slot = self._slots[self._turn]
            self._turn ^= 1
            if slot.done is not None:
                slot.done.synchronize()  # the copy out of this slot has finished
            e = p.batch
            rows = store.feat_shape
            host = [slot.buffer("support", (e, p.support_items.shape[1], *rows), store.dtype, self.cuda),
                    slot.buffer("query", (e, p.query_items.shape[1], *rows), store.dtype, self.cuda)]
            store.gather(p.support_items, p.support_segs, host[0])
            store.gather(p.query_items, p.query_segs, host[1])
            if p.query_mask is not None:
                mask = slot.buffer("mask", p.query_mask.shape, torch.float32, self.cuda)
                mask.numpy()[...] = p.query_mask
                host.append(mask)
            staged = self._copy(slot, host) if self.cuda else host
            support, query = staged[0], staged[1]
            mask = staged[2] if p.query_mask is not None else None
            if mask is not None and store.zero_padding:
                query.mul_(mask.to(query.dtype).reshape(*mask.shape, *[1] * len(rows)))
            if support.dtype == torch.float16:  # a float16 wav store: upcast on the device
                support, query = support.float(), query.float()
            sup_lab, qry_lab, ids = self._layout(p)
            return EpisodeBatch(support=support, support_labels=sup_lab, query=query, query_labels=qry_lab,
                                audio_ids=ids if mask is not None else None, query_mask=mask)

    def _copy(self, slot: _Slot, host: List[torch.Tensor]) -> List[torch.Tensor]:
        compute = torch.cuda.current_stream(self.device)
        nbytes = sum(t.numel() * t.element_size() for t in host)
        start = torch.cuda.Event(enable_timing=True) if self.trace is not None else None
        slot.done = torch.cuda.Event(enable_timing=self.trace is not None)
        with torch.cuda.stream(self.stream):
            if start is not None:
                start.record(self.stream)
            out = [t.to(self.device, non_blocking=True) for t in host]
            slot.done.record(self.stream)
        compute.wait_event(slot.done)
        for t in out:
            t.record_stream(compute)
        self.h2d_bytes += nbytes
        if self.trace is not None:
            self.trace.append((start, slot.done, nbytes))
        return out
