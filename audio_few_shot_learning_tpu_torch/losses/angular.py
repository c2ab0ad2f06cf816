"""Angular Prototypical Loss (counterpart of the JAX package's
``losses/angular.py``), batched over episodes.

On L2-normalized embeddings, triplets (a, p, n) with label(a) == label(p)
!= label(n) are kept when the angle ``atan(|a-p| / (2 |(a+p)/2 - n|))``
exceeds ``angle`` degrees; per (a, p) pair the loss is
``log(1 + sum_n exp(4 tan^2(alpha) (a+p)·n - 2 (1 + tan^2(alpha)) a·p))``
over the kept negatives, with alpha = 40 degrees, averaged over the pairs
that keep at least one negative.

``prototypes_as_anchors=True``: the prototypes are the anchors, the queries
the positives and negatives. ``False``: prototypes and queries are pooled
into one set and mined jointly, an element never its own positive.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _angular_core(
    anchors: torch.Tensor,  # [E, A, D] normalized
    refs: torch.Tensor,  # [E, R, D] normalized: positives and negatives
    anchor_labels: torch.Tensor,  # [E, A]
    ref_labels: torch.Tensor,  # [E, R]
    mine_angle_deg: float,
    loss_alpha_deg: float,
    exclude_self_pairs: bool,
) -> torch.Tensor:
    a_lab = anchor_labels[..., :, None]
    r_lab = ref_labels[..., None, :]
    pos_mask = (a_lab == r_lab).to(anchors.dtype)  # [E, A, R]
    neg_mask = (a_lab != r_lab).to(anchors.dtype)
    if exclude_self_pairs:
        eye = torch.eye(anchors.shape[-2], refs.shape[-2], device=anchors.device, dtype=anchors.dtype)
        pos_mask = pos_mask * (1.0 - eye)

    ap_dot = anchors @ refs.transpose(-1, -2)  # [E, A, R]: a·p, and a·n
    ap_dist = torch.sqrt((2.0 - 2.0 * ap_dot).clamp_min(0.0) + 1e-24)
    # |c - n|^2 with c = (a+p)/2: |c|^2 - 2 c·n + 1
    c_sq = 0.25 * (2.0 + 2.0 * ap_dot)
    pn = refs @ refs.transpose(-1, -2)  # [E, Rp, Rn]
    c_dot_n = 0.5 * (ap_dot[..., :, None, :] + pn[..., None, :, :])  # [E, A, Rp, Rn]
    nc_dist = torch.sqrt((c_sq[..., None] - 2.0 * c_dot_n + 1.0).clamp_min(0.0) + 1e-24)

    angles = torch.atan(ap_dist[..., None] / (2.0 * nc_dist + 1e-24))
    mined = (angles > math.radians(mine_angle_deg)).to(anchors.dtype)
    triplet = pos_mask[..., :, :, None] * neg_mask[..., :, None, :] * mined  # [E, A, Rp, Rn]

    sq_tan = math.tan(math.radians(loss_alpha_deg)) ** 2
    apn = ap_dot[..., :, None, :] + pn[..., None, :, :]  # (a+p)·n
    f = 4.0 * sq_tan * apn - 2.0 * (1.0 + sq_tan) * ap_dot[..., None]

    # per (a, p): log(1 + sum over kept n of exp(f)), in a numerically safe form
    fmax = torch.where(triplet > 0, f, float("-inf")).amax(dim=-1)  # [E, A, Rp]
    has_neg = torch.isfinite(fmax)
    m = torch.where(has_neg, fmax, 0.0).clamp_min(0.0)
    sums = torch.where(triplet > 0, torch.exp(f - m[..., None]), 0.0).sum(dim=-1)
    pair_loss = m + torch.log(torch.exp(-m) + sums)

    pair_valid = (pos_mask > 0) & has_neg
    n_pairs = pair_valid.sum(dim=(-1, -2)).clamp_min(1).to(anchors.dtype)
    return torch.where(pair_valid, pair_loss, 0.0).sum(dim=(-1, -2)) / n_pairs


def angular_loss(
    prototypes: torch.Tensor,  # [E, N, D]
    queries: torch.Tensor,  # [E, B, D]
    query_labels: torch.Tensor,  # [E, B]
    angle: float,
    prototypes_as_anchors: bool,
    loss_alpha_deg: float = 40.0,
) -> torch.Tensor:
    """-> ``[E]``."""
    e, n_way, _ = prototypes.shape
    proto_labels = torch.arange(n_way, device=prototypes.device).expand(e, n_way)
    protos_n = F.normalize(prototypes, dim=-1)
    queries_n = F.normalize(queries, dim=-1)
    query_labels = query_labels.long()
    if prototypes_as_anchors:
        return _angular_core(
            protos_n, queries_n, proto_labels, query_labels,
            mine_angle_deg=angle, loss_alpha_deg=loss_alpha_deg, exclude_self_pairs=False,
        )
    pooled = torch.cat([protos_n, queries_n], dim=1)
    labels = torch.cat([proto_labels, query_labels], dim=1)
    return _angular_core(
        pooled, pooled, labels, labels,
        mine_angle_deg=angle, loss_alpha_deg=loss_alpha_deg, exclude_self_pairs=True,
    )
