"""The comparisons that decide ``correct``, and the plain majority vote the
program's multi-segment accuracies are held to. Imports nothing of the
program."""

from __future__ import annotations

from collections import Counter
from typing import Dict, Iterable, List

import numpy as np
import torch

NEGLIGIBLE = 1e-3  # a leaf whose reference gradient is under this share of the median leaf's moves by round-off


def norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in tensors.items()}


def moving_leaves(ref_grads: Dict[str, float]) -> List[str]:
    """Leaves whose reference gradient is not nought to rounding: at least
    ``NEGLIGIBLE`` of the median leaf's norm."""
    med = float(np.median(list(ref_grads.values())))
    return sorted(k for k, v in ref_grads.items() if v >= NEGLIGIBLE * med)


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], leaves: Iterable[str]) -> Dict[str, float]:
    """Per leaf, the gap between the program's norm and the reference's, over
    the reference's norm of that leaf or of the median leaf, whichever is
    larger (not the norm of their difference). A leaf the program does not
    report reads as unmoved."""
    leaves = list(leaves)
    med = float(np.median([ref[k] for k in leaves]))
    return {k: abs(prog.get(k, 0.0) - ref[k]) / max(ref[k], med) for k in leaves}


def score_numbers(prog: torch.Tensor, ref: torch.Tensor, real: torch.Tensor) -> Dict[str, float]:
    """Scores ``[R, N]`` of the rows ``real`` selects, against the
    reference's. ``score_err``: the largest deviation; ``argmax_gap``: the
    widest gap by which the reference's score of the program's top class
    lies below the reference's best. Both over the spread of the
    reference's scores about each row's mean (their RMS); infinite where
    the program's rows are not the reference's."""
    if prog.shape != ref.shape:
        return dict(score_err=float("inf"), argmax_gap=float("inf"))
    prog, ref = prog[real].double(), ref[real].double()
    scale = (ref - ref.mean(dim=-1, keepdim=True)).pow(2).mean().sqrt().clamp_min(1e-30)
    top = ref.gather(-1, prog.argmax(dim=-1, keepdim=True))[:, 0]
    return dict(score_err=float((prog - ref).abs().max() / scale),
                argmax_gap=float((ref.max(dim=-1).values - top).max() / scale))


def vote(preds: List[int], posts: List[float], tie_strategy: str) -> int:
    """The majority label of one query item's real segments; a tie goes to
    the earliest tied segment's label (""), the smallest tied label
    ("min_label") or the tied label of the highest posterior
    ("max_posterior")."""
    count = Counter(preds)
    most = max(count.values())
    tied = [lab for lab in preds if count[lab] == most]
    if tie_strategy == "min_label":
        return min(tied)
    if tie_strategy == "max_posterior":
        best = max(range(len(preds)), key=lambda i: (count[preds[i]] == most, posts[i]))
        return preds[best]
    return tied[0]


def vote_accuracy(scores: np.ndarray, real: np.ndarray, labels: np.ndarray, s_max: int, tie_strategy: str) -> float:
    """One episode's accuracy over its query items: scores ``[Q*s_max, N]``
    query-major, ``real`` the rows that are segments, ``labels`` per row."""
    q = scores.shape[0] // s_max
    right = 0
    for i in range(q):
        rows = [i * s_max + j for j in range(s_max) if real[i * s_max + j]]
        v = vote([int(scores[r].argmax()) for r in rows], [float(scores[r].max()) for r in rows], tie_strategy)
        right += int(v == labels[i * s_max])
    return right / q
