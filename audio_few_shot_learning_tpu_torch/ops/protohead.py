"""Prototype head: class-mean prototypes + query-to-prototype distances.

Counterpart of the JAX package's ``ops/protohead.py``. The plain PyTorch
version (``compute_prototypes``, ``prototype_scores``,
``batched_episode_scores_reference``) is the one-hot matmul form; the fused
kernel (``csrc/protohead.cu``, K2) runs the whole head for a batch of
episodes in one launch. ``batched_episode_scores`` takes the plain version
for CPU tensors and launches the kernel for CUDA tensors, through an
``autograd.Function`` whose backward is autograd through the plain version,
as ``_fused_scores_bwd`` is in the JAX package.

Shapes: support ``[E, S, D]``, labels ``[E, S]`` ints in ``[0, n_way)``,
queries ``[E, Q, D]`` -> scores ``[E, Q, n_way]`` = ``-||q - proto||``.
"""

from __future__ import annotations

import ctypes

import torch

from audio_few_shot_learning_tpu_torch.ops import cuda_build

SMEM_LIMIT = 48 * 1024


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


def episode_scores_cuda(
    support: torch.Tensor, support_labels: torch.Tensor, queries: torch.Tensor, n_way: int
) -> torch.Tensor:
    """Launch K2 on CUDA tensors; counts the launch in ``episode_scores_cuda.launches``."""
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
    # one block's shared memory: prototypes, their norms and class counts
    # (f32) and the labels (int32); the C entry point refuses more than 48 KB
    smem = 4 * (n_way * d + 2 * n_way + s)
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"n_way={n_way} x D={d} prototypes need {smem} B of shared memory; the "
            f"episode head kernel takes at most {SMEM_LIMIT} B (n_way <= "
            f"{(SMEM_LIMIT - 4 * s) // (4 * d + 8)} at D={d})"
        )
    sup = support.detach().to(torch.float32).contiguous()
    qry = queries.detach().to(torch.float32).contiguous()
    lab = support_labels.to(torch.int32).contiguous()
    out = torch.empty((e, q, n_way), device=support.device, dtype=torch.float32)
    fn = cuda_build.function(
        "protohead",
        "afsl_protohead_scores",
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
    )
    status = fn(
        cuda_build.ptr(sup), cuda_build.ptr(lab), cuda_build.ptr(qry), cuda_build.ptr(out),
        e, s, q, d, n_way, cuda_build.stream_handle(support.device),
    )
    cuda_build.check_launch(status, "protohead kernel")
    episode_scores_cuda.launches += 1
    return out


episode_scores_cuda.launches = 0


class _FusedScores(torch.autograd.Function):
    """K2 forward; backward is autograd through the plain version."""

    @staticmethod
    def forward(ctx, support, support_labels, queries, n_way):
        ctx.save_for_backward(support, support_labels, queries)
        ctx.n_way = n_way
        return episode_scores_cuda(support, support_labels, queries, n_way)

    @staticmethod
    def backward(ctx, grad):
        support, support_labels, queries = ctx.saved_tensors
        with torch.enable_grad():
            s = support.detach().requires_grad_(True)
            q = queries.detach().requires_grad_(True)
            out = batched_episode_scores_reference(s, support_labels, q, ctx.n_way)
            g_sup, g_qry = torch.autograd.grad(out, (s, q), grad)
        return g_sup, None, g_qry, None


def batched_episode_scores(
    support: torch.Tensor, support_labels: torch.Tensor, queries: torch.Tensor, n_way: int
) -> torch.Tensor:
    """Fused episode head for a batch of episodes: the plain version on the
    CPU, K2 on the card."""
    if support.device.type == "cpu":
        return batched_episode_scores_reference(support, support_labels, queries, n_way)
    return _FusedScores.apply(support, support_labels, queries, n_way)
