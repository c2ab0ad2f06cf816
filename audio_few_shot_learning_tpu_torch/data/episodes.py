"""On-device episodic sampling.

Counterpart of the JAX package's ``data/episodes.py``, with its ``vmap``
over episode keys written out as a leading episode axis E and its keys
replaced by one ``torch.Generator`` on the store's device:

* classes drawn without replacement by Gumbel-top-k over the classes with
  enough items, remapped to 0..N-1 in ascending order;
* per class, Floyd's k-subset of ``[0, count)`` plus a shuffle gives a
  uniform ordered sample, split support | query;
* one uniformly random segment per support item, and per query item in
  train and validation episodes;
* test episodes of a multi-segment store (``is_test``) take every segment of
  each query item instead, padded to the store's ``s_max`` query-major, with
  ``audio_ids`` naming each row's query item and ``query_mask`` its real
  segments (the reference's batch_creation.py:53-72 gives a ragged list).

``sample_episode`` draws from a ``PackedStore`` of spectrograms or a
``PackedWavStore`` of waveforms, with the same class and item draws;
``sample_wav_episode`` takes waveform stores only, a ``WavHostStore`` too.
Padded spectrogram rows are zeros; padded waveform rows repeat the item's
last segment, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from audio_few_shot_learning_tpu_torch.data.store import PackedStore
from audio_few_shot_learning_tpu_torch.data.wavstore import PackedWavStore
from audio_few_shot_learning_tpu_torch.utils.profiling import span, spanned


@dataclasses.dataclass
class EpisodeBatch:
    """A batch of E episodes (waveforms ``[.., L]`` in place of ``[.., F, T]``
    for a wav store). Multi-segment test episodes have ``Qtot = Q * s_max``
    query rows and set ``audio_ids`` and ``query_mask``; single-segment
    episodes leave them None (``Qtot = Q``, every row real)."""

    support: torch.Tensor  # [E, S, F, T]
    support_labels: torch.Tensor  # [E, S]
    query: torch.Tensor  # [E, Qtot, F, T]
    query_labels: torch.Tensor  # [E, Qtot]
    audio_ids: Optional[torch.Tensor] = None  # [E, Qtot] query item of each row
    query_mask: Optional[torch.Tensor] = None  # [E, Qtot] float32, 1 = real segment


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


def _segments(store: Union[PackedStore, PackedWavStore], items: torch.Tensor, seg: torch.Tensor):
    if isinstance(store, PackedWavStore):
        return store.extract_segment(items, seg)
    return store.get_segment(items, seg)


def _pick_segments(
    gen: torch.Generator, store: Union[PackedStore, PackedWavStore], items: torch.Tensor
) -> torch.Tensor:
    counts = store.seg_counts[items]
    u = torch.rand(items.shape, generator=gen, device=items.device)
    seg = torch.minimum((u * counts.to(torch.float32)).floor().long(), counts - 1)
    return _segments(store, items, seg)


def _all_segments(store: Union[PackedStore, PackedWavStore], items: torch.Tensor):
    """Every segment of each item ``[E, Q]``, padded to ``s_max`` query-major:
    rows ``[E, Q*s_max, ...]`` and the mask of the real ones ``[E, Q*s_max]``.
    Spectrogram padding is zeroed (the JAX package's padded layout); a
    waveform pad row is the clipped repeat of the item's last segment."""
    e, q = items.shape
    s_max = store.s_max
    counts = store.seg_counts[items][..., None]  # [E, Q, 1]
    seg = torch.arange(s_max, device=items.device)
    real = (seg < counts).reshape(e, q * s_max)
    if isinstance(store, PackedWavStore):
        rows = store.extract_segment(
            items.repeat_interleave(s_max, dim=-1), torch.minimum(seg, counts - 1).reshape(e, -1)
        )
    else:
        rows = store.segments[store.item_segment_rows(items, s_max).reshape(e, -1)]
        rows = rows * real[..., None, None].to(rows.dtype)
    return rows, real.to(torch.float32)


@spanned("afsl.sample")
def sample_episode(
    gen: torch.Generator,
    store: Union[PackedStore, PackedWavStore],
    n_way: int,
    k_support: int,
    k_query: int,
    batch: int = 1,
    is_test: bool = False,
) -> EpisodeBatch:
    """E = ``batch`` independent episodes; with ``is_test`` on a multi-segment
    store the queries carry all their segments. The store must hold at least
    ``n_way`` classes with ``k_support + k_query`` items (``Trainer.evaluate``
    checks; this function does not sync to check)."""
    k = k_support + k_query
    device = store.device
    eligible = (store.class_counts >= k).expand(batch, -1)
    classes = choose_without_replacement(gen, eligible, n_way).sort(dim=-1).values  # [E, N]

    idx = floyd_sample(gen, store.class_counts[classes], k)  # [E, N, k]
    items = store.class_table[classes[..., None], idx]  # [E, N, k]
    sup_items = items[..., :k_support].reshape(batch, n_way * k_support)
    qry_items = items[..., k_support:].reshape(batch, n_way * k_query)

    ways = torch.arange(n_way, device=device)
    support = _pick_segments(gen, store, sup_items)
    support_labels = ways.repeat_interleave(k_support).expand(batch, -1)
    if not (is_test and store.multi_segm):
        return EpisodeBatch(
            support=support,
            support_labels=support_labels,
            query=_pick_segments(gen, store, qry_items),
            query_labels=ways.repeat_interleave(k_query).expand(batch, -1),
        )
    s_max = store.s_max
    query, real = _all_segments(store, qry_items)
    qn = n_way * k_query
    return EpisodeBatch(
        support=support,
        support_labels=support_labels,
        query=query,
        query_labels=ways.repeat_interleave(k_query * s_max).expand(batch, -1),
        audio_ids=torch.arange(qn, device=device).repeat_interleave(s_max).expand(batch, -1),
        query_mask=real,
    )


def sample_episode_batch(
    gen: torch.Generator,
    store: Union[PackedStore, PackedWavStore],
    n_way: int,
    k_support: int,
    k_query: int,
    is_test: bool = False,
    batch: int = 1,
) -> EpisodeBatch:
    """``sample_episode`` under the JAX package's name and argument order
    (``data/episodes.py:224``), a ``torch.Generator`` in place of its key."""
    return sample_episode(gen, store, n_way, k_support, k_query, batch, is_test)


def sample_wav_episode(
    gen,
    store,
    n_way: int,
    k_support: int,
    k_query: int,
    is_test: bool,
    batch: int = 1,
) -> EpisodeBatch:
    """A waveform store's episodes under the JAX package's name and argument
    order (``data/episodes.py:158``): rows ``[E, .., L]`` of raw waveform,
    the log-mel comes downstream. A ``PackedWavStore`` draws on the card
    with ``gen`` a ``torch.Generator`` (``sample_episode``); a
    ``WavHostStore`` on the host with ``gen`` a numpy Generator (its
    ``sample_episode_batch``). A spectrogram store raises."""
    from audio_few_shot_learning_tpu_torch.data.wavhoststore import WavHostStore

    if isinstance(store, PackedWavStore):
        return sample_episode(gen, store, n_way, k_support, k_query, batch, is_test)
    if isinstance(store, WavHostStore):
        with span("afsl.sample"):
            return store.sample_episode_batch(gen, n_way, k_support, k_query, is_test, batch)
    raise TypeError(f"sample_wav_episode takes a PackedWavStore or a WavHostStore, not {type(store).__name__}; "
                    "spectrogram stores go through sample_episode")
