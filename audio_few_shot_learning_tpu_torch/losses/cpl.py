"""Contrastive Prototypical Loss (counterpart of the JAX package's
``losses/cpl.py``), batched over episodes.

For every query, M queries of each class are drawn without replacement by
Gumbel-top-M over the class-membership mask; the logits are the cosine
similarities of the query's own-class prototype with those samples and with
the query itself, over ``t_param``. Own-class slots, and the slots of a
class with fewer than M members, are masked to ``-inf`` inside the softmax,
so every logit row has the static length ``N*M + 1``. The target is the
query itself, and the mean NLL is divided by the number of queries once
more (the reference's ``(1/B) * NLLLoss(mean)``, kept as in the JAX package).

The Gumbel noise is data: ``draw_cpl_gumbel`` draws it from a
``torch.Generator``, and a caller may pass its own.
"""

from __future__ import annotations

from typing import Optional

import torch

from audio_few_shot_learning_tpu_torch.utils.profiling import spanned


def _cosine(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """``a·b / max(|a| |b|, eps)`` along the last axis (``F.cosine_similarity``
    as the JAX package writes it)."""
    dot = (a * b).sum(dim=-1)
    return dot / (a.norm(dim=-1) * b.norm(dim=-1)).clamp_min(eps)


@spanned("afsl.draws")
def draw_cpl_gumbel(
    gen: torch.Generator, n_episodes: int, n_queries: int, n_way: int, device
) -> torch.Tensor:
    """Standard Gumbel noise ``[E, B, N, B]``: one draw per (query, class,
    candidate query)."""
    u = torch.rand((n_episodes, n_queries, n_way, n_queries), generator=gen, device=device)
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(u.clamp(tiny, 1.0 - 2.0**-24)))


def cpl_loss(
    prototypes: torch.Tensor,
    queries: torch.Tensor,
    labels: torch.Tensor,
    m_param: int,
    t_param: float,
    gumbel: Optional[torch.Tensor] = None,
    gen: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """prototypes ``[E, N, D]``, queries ``[E, B, D]``, labels ``[E, B]`` ->
    ``[E]``. ``gumbel [E, B, N, B]`` fixes the sampling; otherwise it is
    drawn from ``gen``."""
    e, n_way, _ = prototypes.shape
    b = queries.shape[1]
    labels = labels.long()
    member = (labels[:, None, :] == torch.arange(n_way, device=labels.device)[None, :, None])
    member = member.to(queries.dtype)  # [E, N, B]: query j belongs to class c
    if gumbel is None:
        gumbel = draw_cpl_gumbel(gen, e, b, n_way, queries.device)
    g = torch.where(member[:, None] > 0, gumbel, float("-inf"))
    idx = torch.topk(g, m_param, dim=-1).indices  # [E, B, N, M] indices into queries
    # 1 where the slot holds a real member (a class smaller than M leaves 0s)
    valid = member[:, None].expand(e, b, n_way, b).gather(-1, idx)

    ep = torch.arange(e, device=queries.device)
    sampled = queries[ep[:, None, None, None], idx]  # [E, B, N, M, D]
    own_proto = prototypes[ep[:, None], labels]  # [E, B, D]
    sims = _cosine(own_proto[:, :, None, None, :], sampled) / t_param  # [E, B, N, M]
    self_sim = _cosine(own_proto, queries) / t_param  # [E, B]

    not_own = torch.arange(n_way, device=labels.device)[None, None, :] != labels[..., None]
    keep = (valid > 0) & not_own[..., None]
    neg_logits = torch.where(keep, sims, float("-inf")).reshape(e, b, n_way * m_param)
    logits = torch.cat([neg_logits, self_sim[..., None]], dim=-1)  # [E, B, N*M+1]
    logp_self = logits[..., -1] - torch.logsumexp(logits, dim=-1)
    return -logp_self.mean(dim=-1) / b
