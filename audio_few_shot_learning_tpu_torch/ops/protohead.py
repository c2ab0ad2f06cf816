"""Prototype head: class-mean prototypes + query-to-prototype distances.

Counterpart of the JAX package's ``ops/protohead.py``. The plain PyTorch
version (``compute_prototypes``, ``prototype_scores``,
``batched_episode_scores_reference``) is the one-hot matmul form; the fused
kernel (``csrc/protohead.cu``, K2) runs the whole head for a batch of
episodes in one launch, one block per episode and tile of queries, each
block reading its inputs in one memory round (``head_plan`` sizes the
launch). ``batched_episode_scores`` takes the plain version
for CPU tensors and launches the kernel for CUDA tensors, through an
``autograd.Function`` whose backward is the closed-form VJP of the head
(``episode_scores_backward``): a few tensor ops on the saved inputs and the
forward's scores, the same function that the JAX package's
``_fused_scores_bwd`` gets from XLA's VJP of its plain head. The backward
has no kernel of its own because the JAX package's has none.

Shapes: support ``[E, S, D]``, labels ``[E, S]`` ints in ``[0, n_way)``,
queries ``[E, Q, D]`` -> scores ``[E, Q, n_way]`` = ``-||q - proto||``.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from audio_few_shot_learning_tpu_torch.ops import cuda_build

# the distance of a clamped d2, sqrt(0 + 1e-24) in float32, as the head computes it
DIST_FLOOR = float(np.sqrt(np.float32(1e-24)))
SMEM_LIMIT = 227 * 1024  # shared memory one block may use on Hopper
Q_TILE = 8  # query rows per block of K2, one per warp (csrc/protohead.cu kWarps)


def _onehot(labels: torch.Tensor, n_way: int, dtype: torch.dtype) -> torch.Tensor:
    """One-hot rows; a label outside [0, n_way) gives an all-zero row."""
    classes = torch.arange(n_way, device=labels.device)
    return (labels[..., None] == classes).to(dtype)


def compute_prototypes(features: torch.Tensor, labels: torch.Tensor, n_way: int) -> torch.Tensor:
    """Per-class mean of support features: [..., S, D], [..., S] -> [..., n_way, D].
    Empty classes give zero prototypes (counts clamped to 1)."""
    onehot = _onehot(labels, n_way, features.dtype)  # [..., S, N]
    counts = onehot.sum(dim=-2).clamp_min(1.0)  # [..., N]
    return (onehot.transpose(-1, -2) @ features) / counts[..., None]


def pairwise_sqeuclidean(queries: torch.Tensor, prototypes: torch.Tensor) -> torch.Tensor:
    """[..., Q, D] x [..., N, D] -> [..., Q, N] squared distances (matmul form)."""
    q2 = (queries * queries).sum(dim=-1, keepdim=True)
    p2 = (prototypes * prototypes).sum(dim=-1)[..., None, :]
    cross = queries @ prototypes.transpose(-1, -2)
    return (q2 + p2 - 2.0 * cross).clamp_min(0.0)


def prototype_scores(queries: torch.Tensor, prototypes: torch.Tensor) -> torch.Tensor:
    """Classification logits = -euclidean distance."""
    return -torch.sqrt(pairwise_sqeuclidean(queries, prototypes) + 1e-24)


def batched_episode_scores_reference(
    support: torch.Tensor, support_labels: torch.Tensor, queries: torch.Tensor, n_way: int
) -> torch.Tensor:
    """Plain PyTorch version of K2 (= ``_batched_episode_scores_xla``)."""
    return prototype_scores(queries, compute_prototypes(support, support_labels, n_way))


def _round4(x: int) -> int:
    return (x + 3) // 4 * 4


def head_smem_bytes(n_way: int, d: int, q_tile: int, s_chunk: int) -> int:
    """Shared memory of one K2 block (``csrc/protohead.cu`` head_smem_bytes):
    prototypes [N, D], query tile [q_tile, D], support chunk [s_chunk, D] and
    class counts [N] in f32, each padded to 16 bytes, then s_chunk int32 labels."""
    return 4 * (_round4(n_way * d) + _round4(q_tile * d) + _round4(s_chunk * d) + _round4(n_way) + s_chunk)


@dataclasses.dataclass(frozen=True)
class HeadPlan:
    """K2's launch: one block per episode and tile of ``q_tile`` query rows,
    the support staged ``s_chunk`` rows at a time (all of it when it fits)."""

    q_tile: int
    s_chunk: int
    smem_bytes: int
    blocks: int


def head_plan(n_episodes: int, n_support: int, n_query: int, d: int, n_way: int) -> HeadPlan:
    """The largest query tile (up to ``Q_TILE``) and support chunk (up to S)
    whose shared memory fits ``SMEM_LIMIT``; raises ValueError when not even
    one query row and one support row fit beside the prototypes."""
    for q_tile in dict.fromkeys((max(1, min(Q_TILE, n_query)), 1)):
        room = SMEM_LIMIT - head_smem_bytes(n_way, d, q_tile, 0)
        s_chunk = min(n_support, max(0, room - 12) // (4 * (d + 1)))
        while s_chunk > 0 and head_smem_bytes(n_way, d, q_tile, s_chunk) > SMEM_LIMIT:
            s_chunk -= 1
        smem = head_smem_bytes(n_way, d, q_tile, s_chunk)
        if smem <= SMEM_LIMIT and (s_chunk > 0 or n_support == 0):
            return HeadPlan(q_tile, s_chunk, smem, n_episodes * cuda_build.cdiv(n_query, q_tile))
    need = head_smem_bytes(n_way, d, 1, min(n_support, 1))
    raise ValueError(
        f"n_way={n_way} x D={d} prototypes need {need} B of shared memory with one query "
        f"and one support row; the episode head kernel takes at most {SMEM_LIMIT} B"
    )


def _rows(x: torch.Tensor) -> torch.Tensor:
    """``x [E, R, D]`` as float32 whose rows are contiguous within an episode
    (any episode stride): ``x`` itself when it is one, else a copy."""
    x = x.detach().to(torch.float32)
    _, r, d = x.shape
    if (d > 1 and x.stride(2) != 1) or (r > 1 and x.stride(1) != d):
        x = x.contiguous()
    return x


def episode_scores_cuda(
    support: torch.Tensor, support_labels: torch.Tensor, queries: torch.Tensor, n_way: int
) -> torch.Tensor:
    """Launch K2 on CUDA tensors; counts the launch in ``episode_scores_cuda.launches``.

    Float32 features whose rows are contiguous within an episode (slices of
    a larger batch included) and int32 or int64 labels at any strides
    (expanded over episodes included) go to the kernel as they are: the
    call launches K2 and nothing else."""
    if not (support.is_cuda and queries.is_cuda and support_labels.is_cuda):
        raise ValueError("episode_scores_cuda needs CUDA tensors")
    if support.dim() != 3 or queries.dim() != 3 or support_labels.dim() != 2:
        raise ValueError(
            f"expected support [E,S,D], labels [E,S], queries [E,Q,D]; got "
            f"{tuple(support.shape)}, {tuple(support_labels.shape)}, {tuple(queries.shape)}"
        )
    e, s, d = support.shape
    q = queries.shape[1]
    if queries.shape[0] != e or queries.shape[2] != d or tuple(support_labels.shape) != (e, s):
        raise ValueError("support, labels and queries disagree on E, S or D")
    plan = head_plan(e, s, q, d, n_way)
    sup, qry = _rows(support), _rows(queries)
    lab = support_labels
    if lab.dtype not in (torch.int32, torch.int64):
        lab = lab.to(torch.int64)
    out = torch.empty((e, q, n_way), device=support.device, dtype=torch.float32)
    fn = cuda_build.function(
        "protohead",
        "afsl_protohead_scores",
        [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int]
        + [ctypes.c_longlong] * 2 + [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
        + [ctypes.c_int] * 7 + [ctypes.c_void_p],
    )
    status = fn(
        cuda_build.ptr(sup), sup.stride(0), cuda_build.ptr(lab), lab.element_size(),
        lab.stride(0), lab.stride(1), cuda_build.ptr(qry), qry.stride(0), cuda_build.ptr(out),
        e, s, q, d, n_way, plan.q_tile, plan.s_chunk, cuda_build.stream_handle(support.device),
    )
    cuda_build.check_launch(status, "protohead kernel")
    episode_scores_cuda.launches += 1
    return out


episode_scores_cuda.launches = 0


def episode_scores_backward(
    grad: torch.Tensor,
    support: torch.Tensor,
    support_labels: torch.Tensor,
    queries: torch.Tensor,
    scores: torch.Tensor,
    n_way: int,
):
    """Closed-form VJP of ``scores = -sqrt(clamp_min(d2, 0) + 1e-24)``,
    ``d2 = |q|^2 + |p|^2 - 2 q·p``, ``p`` the class means of the support.

    With ``dist = -scores`` and ``G = grad * [d2 > 0] / dist`` (``[E, Q, N]``):
    ``g_q = G P - rowsum(G) q``, ``g_P = G^T Q - colsum(G) P`` and
    ``g_support = onehot (g_P / counts)``. ``d2`` was clamped exactly where
    ``dist`` is ``DIST_FLOOR``. Returns ``(g_support [E, S, D], g_queries
    [E, Q, D])`` in float32 (float64 for float64 inputs)."""
    dtype = torch.promote_types(support.dtype, torch.float32)
    sup = support.detach().to(dtype)
    qry = queries.detach().to(dtype)
    dist = -scores.detach().to(dtype)
    g = torch.where(dist > DIST_FLOOR, grad.to(dtype) / dist, 0.0)  # G [E, Q, N]
    onehot = _onehot(support_labels, n_way, dtype)  # [E, S, N]
    counts = onehot.sum(dim=-2).clamp_min(1.0)  # [E, N]
    protos = (onehot.transpose(-1, -2) @ sup) / counts[..., None]  # [E, N, D]
    g_qry = g @ protos - g.sum(dim=-1, keepdim=True) * qry
    g_protos = g.transpose(-1, -2) @ qry - g.sum(dim=-2)[..., None] * protos
    g_sup = onehot @ (g_protos / counts[..., None])
    return g_sup, g_qry


class _FusedScores(torch.autograd.Function):
    """The head's forward (K2 on the card, the plain version on the CPU);
    backward ``episode_scores_backward``."""

    @staticmethod
    def forward(ctx, support, support_labels, queries, n_way):
        if support.device.type == "cpu":
            out = batched_episode_scores_reference(support, support_labels, queries, n_way)
        else:
            out = episode_scores_cuda(support, support_labels, queries, n_way)
        ctx.save_for_backward(support, support_labels, queries, out)
        ctx.n_way = n_way
        return out

    @staticmethod
    def backward(ctx, grad):
        support, support_labels, queries, out = ctx.saved_tensors
        g_sup, g_qry = episode_scores_backward(grad, support, support_labels, queries, out, ctx.n_way)
        return g_sup.to(support.dtype), None, g_qry.to(queries.dtype), None


def batched_episode_scores(
    support: torch.Tensor, support_labels: torch.Tensor, queries: torch.Tensor, n_way: int
) -> torch.Tensor:
    """Fused episode head for a batch of episodes: the plain version on the
    CPU, K2 on the card; differentiable in support and queries."""
    return _FusedScores.apply(support, support_labels, queries, n_way)
