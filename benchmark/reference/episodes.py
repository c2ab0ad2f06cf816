"""The program's sampled episodes and random draws, judged, and read back
into the reference's own inputs. Imports nothing of the program.

The sampler's choice of classes, items and segments is random, so the
reference takes it from the program's episode, but only as rows it finds in
the raw split: each row is looked up by the bits of its first values and
then compared whole with the split's row in the program's dtype. An episode
is sound where every row is found, its items are distinct, each label's
rows come from one class and the labels' classes differ, each label has
its shots and queries, and (multi-segment) each query item's block holds
its segments in order, the mask marks them and the padding rows are zero.
The reference then gathers the float32 rows of its own split by those
indices. The SpecAugment draws, the view shuffle and CPL's noise are taken
as they are, held to their law: the warp's curve ends at -1 and 1, the
masks cover no more than their widths allow, the shuffle is a permutation.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

KEY_VALUES = 4  # the first values of a row that make its key


def _key(rows: torch.Tensor) -> torch.Tensor:
    """One int64 key a row ``[R, ...]`` from the bits of its first values."""
    head = rows.reshape(rows.shape[0], -1)[:, :KEY_VALUES].contiguous()
    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[head.element_size()]
    bits = head.view(ints).long()
    key = torch.zeros(bits.shape[0], dtype=torch.long, device=bits.device)
    for j in range(bits.shape[1]):
        key = key * 1_000_003 + bits[:, j]
    return key


class SplitIndex:
    """Finds rows of the program's episodes in the raw split."""

    def __init__(self, split: Dict[str, torch.Tensor], dtype: torch.dtype):
        self.split, self.dtype = split, dtype
        g = split["segments"].shape[0]
        keys = _key(split["segments"].reshape(g, -1)[:, :KEY_VALUES].to(dtype))
        self.keys, self.order = keys.sort()

    def find(self, rows: torch.Tensor) -> torch.Tensor:
        """The split's row of each of ``rows [R, F, T]`` (on the split's
        device), -1 where none is equal to it."""
        if rows.shape[0] == 0:
            return torch.zeros(0, dtype=torch.long, device=self.keys.device)
        rows = rows.to(self.keys.device)
        k = _key(rows)
        pos = torch.searchsorted(self.keys, k).clamp(max=len(self.keys) - 1)
        g = torch.where(self.keys[pos] == k, self.order[pos], -1)
        same = (self.split["segments"][g.clamp_min(0)].to(self.dtype) == rows).reshape(len(rows), -1).all(-1)
        return torch.where(same & (g >= 0), g, -1)

    def item_of(self, g: torch.Tensor) -> torch.Tensor:
        return torch.searchsorted(self.split["offsets"], g, right=True) - 1


def _episode_faults(items: List[int], labels: List[int], classes: List[int], n_way: int, ks: int, kq: int) -> int:
    """1 where one episode's items (support then query) break the episode's
    law, else 0."""
    if len(set(items)) != len(items):
        return 1
    by_label: Dict[int, set] = {}
    for lab, c in zip(labels, classes):
        by_label.setdefault(lab, set()).add(c)
    if sorted(by_label) != list(range(n_way)) or any(len(cs) != 1 for cs in by_label.values()):
        return 1
    if len({next(iter(cs)) for cs in by_label.values()}) != n_way:
        return 1
    sup, qry = labels[: n_way * ks], labels[n_way * ks:]
    return int(any(sup.count(j) != ks or qry.count(j) != kq for j in range(n_way)))


def judge_episodes(index: SplitIndex, ep: dict, n_way: int, ks: int, kq: int, s_max: int = 1
                   ) -> Tuple[int, torch.Tensor, torch.Tensor]:
    """Faults of the program's episode batch ``ep`` (``support [E, S, F, T]``,
    ``support_labels``, ``query [E, Qtot, F, T]``, ``query_labels``,
    ``query_mask`` or None), and the split's rows of its support ``[E, S]``
    and queries ``[E, Qtot]`` (-1 for padding and rows not found)."""
    split = index.split
    sup, qry = ep["support"], ep["query"]
    e, s = sup.shape[:2]
    qtot = qry.shape[1]
    sup_g = index.find(sup.reshape(e * s, *sup.shape[2:])).reshape(e, s)
    mask = ep.get("query_mask")
    real = torch.ones(e, qtot, dtype=torch.bool, device=qry.device) if mask is None else mask.bool()
    flat = qry.reshape(e * qtot, *qry.shape[2:])
    qry_g = torch.full((e * qtot,), -1, dtype=torch.long, device=sup_g.device)
    real_flat = real.reshape(-1).to(qry_g.device)
    qry_g[real_flat] = index.find(flat[real.reshape(-1)])
    pad_nonzero = (flat[~real.reshape(-1)] != 0).reshape(-1, flat[0].numel()).any(-1).sum().item()
    qry_g = qry_g.reshape(e, qtot)
    sup_i, qry_i = index.item_of(sup_g), index.item_of(qry_g)
    counts, labels_of = split["counts"], split["labels"]
    faults = int(pad_nonzero > 0) + int((sup_g < 0).any()) + int((qry_g[real.to(qry_g.device)] < 0).any())
    q = qtot // s_max
    seg = torch.arange(s_max, device=qry_g.device)
    for k in range(e):
        items = sup_i[k].tolist()
        if s_max > 1:
            first = qry_i[k].reshape(q, s_max)[:, 0]
            want = split["offsets"][first][:, None] + seg  # every segment of the block's item, in order
            want_real = seg < counts[first][:, None]
            got = qry_g[k].reshape(q, s_max)
            faults += int(not bool(((got == want) | ~want_real).all() and (real[k].reshape(q, s_max).to(
                want_real.device) == want_real).all()))
            items += first.tolist()
            q_labels = ep["query_labels"][k].reshape(q, s_max)[:, 0].tolist()
        else:
            items += qry_i[k].tolist()
            q_labels = ep["query_labels"][k].tolist()
        labels = ep["support_labels"][k].tolist() + q_labels
        classes = labels_of[torch.as_tensor(items, device=labels_of.device).clamp_min(0)].tolist()
        faults += _episode_faults(items, labels, classes, n_way, ks, kq)
    return faults, sup_g, qry_g


def gather(split: Dict[str, torch.Tensor], g: torch.Tensor) -> torch.Tensor:
    """The split's float32 rows ``g [...]``, zero rows where ``g`` is -1."""
    rows = split["segments"][g.clamp_min(0)]
    return rows * (g >= 0)[..., None, None].to(rows.dtype)


def draw_faults(draws: Optional[tuple], params: dict, f_len: int, t_len: int) -> int:
    """Episodes whose SpecAugment draws ``(ys [E, B, T], tmask [E, T],
    fmask [E, F])`` break the law: a warp curve that does not run from -1
    to 1, or a mask wider than ``num_mask`` intervals of its width allow."""
    if draws is None:
        return 0
    ys, tmask, fmask = draws
    n = params["num_mask"]
    t_max = max(min(params["mask_param"], int(params["p"] * t_len)), 1)
    bad = ((ys[..., 0] + 1).abs() > 1e-5).any(-1) | ((ys[..., -1] - 1).abs() > 1e-5).any(-1)
    bad |= tmask.bool().sum(-1) > n * t_max
    bad |= fmask.bool().sum(-1) > n * params["mask_param"]
    return int(bad.sum())


def perm_faults(perms: Optional[torch.Tensor], views: int) -> int:
    """Episodes whose view shuffle ``[E, V-1]`` is no permutation of 1..V-1."""
    if perms is None:
        return 0
    want = torch.arange(1, views, device=perms.device)
    return int((perms.sort(-1).values != want).any(-1).sum())
