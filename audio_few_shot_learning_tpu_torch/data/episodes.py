"""On-device episodic sampling (single segment).

Counterpart of the JAX package's ``data/episodes.py``, with its ``vmap``
over episode keys written out as a leading episode axis E and its keys
replaced by one ``torch.Generator`` on the store's device:

* classes drawn without replacement by Gumbel-top-k over the classes with
  enough items, remapped to 0..N-1 in ascending order;
* per class, Floyd's k-subset of ``[0, count)`` plus a shuffle gives a
  uniform ordered sample, split support | query;
* one uniformly random segment per item.

``sample_episode`` draws from a ``PackedStore`` of spectrograms,
``sample_wav_episode`` from a ``PackedWavStore`` of waveforms, with the same
class and item draws. Multi-segment test episodes are a later slice.
"""

from __future__ import annotations

import dataclasses
from typing import Union

import torch

from audio_few_shot_learning_tpu_torch.data.store import PackedStore
from audio_few_shot_learning_tpu_torch.data.wavstore import PackedWavStore


@dataclasses.dataclass
class EpisodeBatch:
    """A batch of E single-segment episodes (waveforms ``[.., L]`` in
    place of ``[.., F, T]`` for a wav store)."""

    support: torch.Tensor  # [E, S, F, T]
    support_labels: torch.Tensor  # [E, S]
    query: torch.Tensor  # [E, Q, F, T]
    query_labels: torch.Tensor  # [E, Q]


def choose_without_replacement(gen: torch.Generator, mask: torch.Tensor, k: int) -> torch.Tensor:
    """Gumbel-top-k: ``[E, M]`` mask -> ``[E, k]`` distinct indices where mask > 0."""
    u = torch.rand(mask.shape, generator=gen, device=mask.device)
    g = -torch.log(-torch.log(u.clamp(1e-20, 1.0 - 1e-7)))
    g = torch.where(mask > 0, g, float("-inf"))
    return torch.topk(g, k, dim=-1).indices


def floyd_sample(gen: torch.Generator, count: torch.Tensor, k: int) -> torch.Tensor:
    """k distinct uniform positions in ``[0, count)`` in uniformly random
    order, for every entry of ``count`` (shape ``[...]``, each >= k) ->
    ``[..., k]``: the distribution of ``random.sample(range(count), k)``."""
    u = torch.rand(count.shape + (k,), generator=gen, device=count.device)
    chosen = torch.full(count.shape + (k,), -1, dtype=torch.long, device=count.device)
    for i in range(k):
        j = count.long() - k + i
        t = torch.minimum((u[..., i] * (j + 1).to(torch.float32)).long(), j)
        hit = (chosen == t[..., None]).any(dim=-1)
        chosen[..., i] = torch.where(hit, j, t)
    perm = torch.rand(chosen.shape, generator=gen, device=count.device).argsort(dim=-1)
    return chosen.gather(-1, perm)


def _pick_segments(
    gen: torch.Generator, store: Union[PackedStore, PackedWavStore], items: torch.Tensor
) -> torch.Tensor:
    counts = store.seg_counts[items]
    u = torch.rand(items.shape, generator=gen, device=items.device)
    seg = torch.minimum((u * counts.to(torch.float32)).floor().long(), counts - 1)
    if isinstance(store, PackedWavStore):
        return store.extract_segment(items, seg)
    return store.get_segment(items, seg)


def sample_episode(
    gen: torch.Generator,
    store: Union[PackedStore, PackedWavStore],
    n_way: int,
    k_support: int,
    k_query: int,
    batch: int = 1,
) -> EpisodeBatch:
    """E = ``batch`` independent single-segment episodes. The store must hold
    at least ``n_way`` classes with ``k_support + k_query`` items
    (``Trainer.evaluate`` checks; this function does not sync to check)."""
    k = k_support + k_query
    device = store.device
    eligible = (store.class_counts >= k).expand(batch, -1)
    classes = choose_without_replacement(gen, eligible, n_way).sort(dim=-1).values  # [E, N]

    idx = floyd_sample(gen, store.class_counts[classes], k)  # [E, N, k]
    items = store.class_table[classes[..., None], idx]  # [E, N, k]
    sup_items = items[..., :k_support].reshape(batch, n_way * k_support)
    qry_items = items[..., k_support:].reshape(batch, n_way * k_query)

    ways = torch.arange(n_way, device=device)
    return EpisodeBatch(
        support=_pick_segments(gen, store, sup_items),
        support_labels=ways.repeat_interleave(k_support).expand(batch, -1),
        query=_pick_segments(gen, store, qry_items),
        query_labels=ways.repeat_interleave(k_query).expand(batch, -1),
    )


def sample_wav_episode(
    gen: torch.Generator,
    store: PackedWavStore,
    n_way: int,
    k_support: int,
    k_query: int,
    batch: int = 1,
    is_test: bool = False,
) -> EpisodeBatch:
    """E = ``batch`` wav episodes (support ``[E, S, seg_len]``, query
    ``[E, Q, seg_len]`` raw waveforms; the mel comes downstream), drawn as
    ``sample_episode`` draws, one random segment per item."""
    if is_test and store.multi_segm:
        raise NotImplementedError("multi-segment wav test episodes are a later slice of the port")
    return sample_episode(gen, store, n_way, k_support, k_query, batch)
