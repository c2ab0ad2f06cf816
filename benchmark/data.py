"""The split of a benchmark run, made on the device from the run's seed. The
program's store is built from it; the reference makes it again after the
program's state is freed.

Every size comes from the configuration's ``dataset`` group; a seed changes
the values and the order, never the amount of work: the segment counts are
a fixed multiset that the seed only permutes, so ``s_max`` is the same in
every run.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch


def sub_seed(seed: int, k: int) -> int:
    """The k-th stream of a run's seed (any integer, negative too)."""
    return (int(seed) * 1_000_003 + 7_919 * k) % (2**62)


def generator(seed: int, k: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, k))


def segment_counts(dataset: dict) -> torch.Tensor:
    """Segments of each of the split's items, in no order: 1 each, or with
    ``durations_s`` (a lognormal law of recording lengths: ``median``,
    ``sigma``, clipped to ``[min, max]``) the law's quantiles at
    ``(i + 0.5) / I`` cut into ``segment_s``-second segments, the last one
    partial."""
    n = dataset["classes"] * dataset["items_per_class"]
    law = dataset.get("durations_s")
    if law is None:
        return torch.ones(n, dtype=torch.long)
    p = (torch.arange(n, dtype=torch.float64) + 0.5) / n
    secs = (law["median"] * torch.exp(law["sigma"] * torch.special.ndtri(p))).clamp(law["min"], law["max"])
    return torch.ceil(secs / dataset["segment_s"] - 1e-9).long().clamp_min(1)


def split_layout(dataset: dict, seed: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per item ``(label, segment count)`` on the CPU: items grouped by
    class, ``items_per_class`` each; the counts in an order the seed
    permutes."""
    counts = segment_counts(dataset)
    perm = torch.randperm(len(counts), generator=torch.Generator().manual_seed(sub_seed(seed, 1)))
    labels = torch.arange(dataset["classes"]).repeat_interleave(dataset["items_per_class"])
    return labels, counts[perm]


def make_split(dataset: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The split as flat arrays: ``segments [G, F, T]`` float32 standard
    normal noise (z-scored features) made in one call on ``device``,
    ``labels [I]``, ``counts [I]`` and ``offsets [I]`` (first row of each item)."""
    labels, counts = split_layout(dataset, seed)
    f, t = dataset["feat_shape"]
    total = int(counts.sum())
    segments = torch.randn((total, f, t), generator=generator(seed, 2, device), device=device)
    offsets = torch.cumsum(counts, 0) - counts
    put = lambda x: x.to(device)  # noqa: E731
    return dict(segments=segments, labels=put(labels), counts=put(counts), offsets=put(offsets))
