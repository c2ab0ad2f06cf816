"""Multi-segment evaluation: the majority vote over an item's segments.

Counterpart of the JAX package's ``train/evaluate.py``, with its ``vmap``
over episodes written out as a leading episode axis E. Every query item is
scored segment by segment over the padded ``[Q, S_max]`` layout; its vote is
the most frequent predicted label among its real segments, ties broken by
``tie_strategy`` (the reference's loops/loops.py:169-247):

  ""              the first tied label in segment order
  "min_label"     the smallest tied label
  "max_posterior" the label of the highest-posterior segment among the
                  tied labels' segments

``majority_vote_accuracy_host`` is the reference's loop over segment ids in
numpy: the oracle the device version is tested against.
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import torch

TIE_STRATEGIES = ("", "min_label", "max_posterior")


def majority_vote_accuracy(
    predictions: torch.Tensor,  # [E, Q, S] predicted label per segment
    posteriors: torch.Tensor,  # [E, Q, S] max score per segment
    seg_mask: torch.Tensor,  # [E, Q, S] 1 = real segment, 0 = padding
    true_labels: torch.Tensor,  # [E, Q]
    n_way: int,
    tie_strategy: str = "",
) -> torch.Tensor:
    """Share of the Q query items whose vote is their label, per episode: ``[E]`` float32."""
    if tie_strategy not in TIE_STRATEGIES:
        raise ValueError(f"unknown tie_strategy {tie_strategy!r}")
    real = seg_mask > 0
    ways = torch.arange(n_way, device=predictions.device)
    counts = ((predictions[..., None] == ways) & real[..., None]).sum(dim=2)  # [E, Q, N]
    tied = (counts == counts.amax(dim=-1, keepdim=True)) & (counts > 0)

    if tie_strategy == "min_label":
        vote = tied.to(torch.uint8).argmax(dim=-1)  # the first True: the smallest label
    else:
        seg_tied = tied.gather(-1, predictions) & real  # [E, Q, S]: the segment's label is tied
        if tie_strategy == "max_posterior":
            key = torch.where(seg_tied, posteriors.to(torch.float32), float("-inf"))
        else:  # "": the earliest tied segment
            key = seg_tied.to(torch.uint8)
        seg = key.argmax(dim=-1, keepdim=True)  # argmax takes the first of equal maxima
        vote = predictions.gather(-1, seg)[..., 0]
    # correct votes over Q in float64, then rounded once to float32: the host
    # loop's value (a float32 division by a scalar runs as a multiply by its
    # reciprocal on the card, 5 / 25 -> 0.19999999)
    correct = (vote == true_labels).sum(dim=-1).to(torch.float64)
    return (correct / true_labels.shape[-1]).to(torch.float32)


def majority_vote_accuracy_host(
    predicted_labels: np.ndarray,
    spectrogram_ids: np.ndarray,
    query_labels: np.ndarray,
    posterior_values: np.ndarray,
    tie_strategy: str = "min_label",
) -> float:
    """The reference's calculate_majority_vote_accuracy (loops/loops.py:169-247)
    over one episode's real segments, each tagged with its query item's id."""
    unique_segments = np.unique(spectrogram_ids)
    correct = 0
    for segment in unique_segments:
        idx = [i for i, sid in enumerate(spectrogram_ids) if sid == segment]
        preds = [int(predicted_labels[i]) for i in idx]
        trues = [int(query_labels[i]) for i in idx]
        posts = [posterior_values[i] for i in idx]

        cnt = Counter(preds)
        max_count = max(cnt.values())
        tied = [lab for lab, c in cnt.items() if c == max_count]
        if len(tied) == 1:
            vote = tied[0]
        elif tie_strategy == "min_label":
            vote = min(tied)
        elif tie_strategy == "max_posterior":
            best, vote = -np.inf, None
            for i, lab in enumerate(preds):
                if lab in tied and posts[i] > best:
                    best, vote = posts[i], lab
        else:
            vote = tied[0]
        if vote == trues[0]:
            correct += 1
    return correct / len(unique_segments)
