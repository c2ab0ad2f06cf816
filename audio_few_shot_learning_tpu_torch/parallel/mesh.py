"""Episode-axis data parallelism: the process group, each rank's share of an
episode batch, and the collectives the engine issues.

Counterpart of the JAX package's ``parallel/mesh.py``. There a step's batch
of E episodes is sharded over the ``episode`` axis of one program and XLA
inserts the reductions. Here each of W ranks is a process with its own
device (``torch.distributed``: NCCL between cards, gloo on the CPU), holds
E/W of the episodes, and the engine reduces explicitly:

* the train-mode BatchNorm moments of every forward, over the global batch
  (``combine_moments``), and in its backward the sums that the gradients
  of the global mean and variance need (``CrossRankBatchNorm``);
* the gradients and the step's metrics, once per optimizer step
  (``all_reduce_mean_``);
* eval accuracies and the generator states of a resume checkpoint,
  gathered into the global order (``gather``).

Parameters start equal on every rank (``broadcast_`` from rank 0) and stay
equal: every rank takes the same Adam step on the same averaged gradients.
Collectives are ``all_reduce`` and ``broadcast`` only, the two that gloo
runs on CUDA tensors as well; a gather is each rank writing its rows into a
zero buffer, then one ``all_reduce``.

Launch with ``torchrun --nproc_per_node W -m <entry point> ...`` and
``"tpu": {"mesh_shape": W}``: the CLIs call ``maybe_initialize_distributed``,
which reads torchrun's environment, and each rank runs on ``cuda:LOCAL_RANK``.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from audio_few_shot_learning_tpu_torch.utils.profiling import span

EPISODE_AXIS = "episode"


def local_rank() -> int:
    """This process's index on its host (torchrun's ``LOCAL_RANK``; 0 alone)."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def maybe_initialize_distributed(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    backend: Optional[str] = None,
    timeout_s: Optional[float] = None,
) -> bool:
    """Join the process group of a data-parallel run; True if this process
    is in one (now or already).

    Explicit arguments win; otherwise torchrun's ``RANK``, ``WORLD_SIZE``
    and ``MASTER_ADDR`` (rendezvous ``env://``) are read. Without them it is
    a no-op that returns False, as the JAX package's is without a
    coordinator address: a single-process run never starts the runtime.
    ``backend`` defaults to NCCL where a card is present (each rank on
    ``cuda:LOCAL_RANK``) and gloo otherwise; a run on the CPU passes
    ``"gloo"``."""
    if dist.is_initialized():
        return True
    env = os.environ
    if world_size is None and "WORLD_SIZE" in env:
        world_size = int(env["WORLD_SIZE"])
    if rank is None and "RANK" in env:
        rank = int(env["RANK"])
    if init_method is None and "MASTER_ADDR" in env:
        init_method = "env://"
    if init_method is None or world_size is None or rank is None:
        return False
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(local_rank())
    kwargs = {} if timeout_s is None else {"timeout": datetime.timedelta(seconds=timeout_s)}
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank, **kwargs)
    return True


def process_rank() -> int:
    """This process's rank in the initialised group, 0 without one."""
    return dist.get_rank() if dist.is_initialized() else 0


@dataclasses.dataclass(frozen=True)
class EpisodeMesh:
    """``world`` ranks along the ``episode`` axis; this process is ``rank``
    and runs on ``device``. ``group`` is the process group, None for a
    single process outside any group, which issues no collective."""

    rank: int
    world: int
    device: torch.device
    group: Optional[object] = None

    def shares(self, n: int) -> List[int]:
        """Each rank's count of ``n`` episodes: ``n // world``, one more on
        the first ``n % world`` ranks (a rank may get none)."""
        base, extra = divmod(n, self.world)
        return [base + (r < extra) for r in range(self.world)]

    def episode_shard(self, n: int) -> slice:
        """This rank's contiguous share of ``n`` episodes (``shares``)."""
        counts = self.shares(n)
        lo = sum(counts[: self.rank])
        return slice(lo, lo + counts[self.rank])

    def chunk_shard(self, n: int, chunk: int) -> List[int]:
        """This rank's episodes of a global batch of ``n`` that goes through
        in chunks of ``chunk``: its share of every chunk, chunk by chunk
        (JAX ``train/engine.py:360-367`` shards each chunk over the mesh)."""
        share = self.episode_shard(chunk)
        return [c + i for c in range(0, n, chunk) for i in range(share.start, share.stop)]

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the ranks in place (nothing outside a group)."""
        if self.group is not None:
            dist.all_reduce(t, group=self.group)
        return t

    def all_reduce_mean_(self, tensors: Sequence[torch.Tensor]) -> None:
        """Average each tensor over the ranks, in place, with one collective
        over a flat buffer of all of them (floating tensors of one dtype)."""
        if self.group is None or not tensors:
            return
        with span("afsl.allreduce"):
            flat = torch.cat([t.reshape(-1) for t in tensors])
            self.all_reduce_(flat).div_(self.world)
            offset = 0
            for t in tensors:
                t.copy_(flat[offset : offset + t.numel()].view_as(t))
                offset += t.numel()

    def broadcast_(self, tensors: Sequence[torch.Tensor]) -> None:
        """Every tensor as rank 0 holds it, on every rank (the JAX
        ``replicated`` sharding)."""
        if self.group is None:
            return
        for t in tensors:
            dist.broadcast(t, src=0, group=self.group)

    def gather(self, local: torch.Tensor, positions: Sequence[int], total: int) -> torch.Tensor:
        """``total`` rows on every rank, the rows of each rank's ``local`` at
        its ``positions`` (the JAX ``from_process_local`` read back): each
        rank writes its rows into a zero buffer and one all_reduce sums
        the buffers. Integer and floating rows come back exactly."""
        buf = torch.zeros((total,) + tuple(local.shape[1:]), dtype=local.dtype, device=self.device)
        if len(positions):
            index = torch.as_tensor(list(positions), dtype=torch.long, device=self.device)
            buf.index_copy_(0, index, local.to(self.device))
        return self.all_reduce_(buf)

    def barrier(self) -> None:
        """Return once every rank has reached this point (a one-element
        all_reduce read back on the host)."""
        if self.group is not None:
            self.all_reduce_(torch.ones(1, device=self.device)).item()


def make_mesh(n: Optional[int] = None, device: Union[str, torch.device, None] = None) -> EpisodeMesh:
    """The ``episode`` mesh of this process: the initialised process group,
    whose world size ``n`` (``tpu.mesh_shape``; None takes the group's) must
    equal, on ``device`` (default ``cuda:LOCAL_RANK``). Without a group the
    mesh is this process alone (default ``cuda:0``), and asking for ``n`` > 1
    raises: a data-parallel configuration never runs on one device."""
    if not dist.is_initialized():
        if n is not None and n > 1:
            raise RuntimeError(
                f"tpu.mesh_shape={n} needs {n} processes in an initialised process group: launch "
                f"with torchrun --nproc_per_node {n} (each rank calls maybe_initialize_distributed)"
            )
        return EpisodeMesh(0, 1, torch.device("cuda:0" if device is None else device))
    world = dist.get_world_size()
    if n is not None and n != world:
        raise ValueError(f"tpu.mesh_shape={n} but the process group holds {world} ranks")
    device = torch.device(f"cuda:{local_rank()}" if device is None else device)
    return EpisodeMesh(dist.get_rank(), world, device, dist.group.WORLD)


def combine_moments(
    mesh: EpisodeMesh, count: int, mean: torch.Tensor, var: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-channel mean and biased variance over every rank's rows from each
    rank's ``count`` rows, ``mean`` and biased ``var`` (``[C]``), and the
    total count (a float64 tensor on the device: no host synchronization).

    Every rank's (count, mean, M2 = count * var) is gathered in float64 and
    combined by Chan's parallel formula, M2 = sum M2_r + sum n_r (m_r - m)^2,
    on every rank in the same order: no sum of squares, whose cancellation
    the two-pass variance of one process avoids."""
    c = mean.numel()
    row = torch.cat([mean.new_tensor([float(count)]), mean, var]).to(torch.float64)
    rows = mesh.gather(row[None], [mesh.rank], mesh.world)
    n, m, v = rows[:, :1], rows[:, 1 : 1 + c], rows[:, 1 + c :]
    total = n.sum()
    g_mean = (n * m).sum(0) / total
    g_var = (n * (v + (m - g_mean).square())).sum(0) / total
    return g_mean.to(mean.dtype), g_var.to(var.dtype), total


def _channel_view(t: torch.Tensor, dim: int) -> torch.Tensor:
    return t.reshape((1, -1) + (1,) * (dim - 2))


class CrossRankBatchNorm(torch.autograd.Function):
    """Train-mode BatchNorm of this rank's rows ``x [B, C, ...]`` with the
    moments of every rank's rows, in float32; returns the output in ``x``'s
    dtype and, not differentiable, the global mean, biased variance and
    count.

    Forward: ``combine_moments`` of each rank's two-pass moments. Backward:
    every rank's loss depends on the global moments, so the sums their
    gradients need, sum(g) and sum(g * x_hat) per channel, are all-reduced
    (float64) and each rank takes BatchNorm's own input gradient
    ``(g - mean(g) - x_hat * mean(g * x_hat)) * inv_std * weight`` with the
    global means: grouped as one process's BatchNorm groups it, so the
    terms that cancel are subtracted before they are scaled. The affine's
    gradient is this rank's share; the step's gradient all-reduce sums it."""

    @staticmethod
    def forward(ctx, x, weight, bias, mesh: EpisodeMesh, eps: float):
        dims = [0] + list(range(2, x.dim()))
        xf = x.to(torch.float32)
        var, mean = torch.var_mean(xf, dim=dims, correction=0)
        mean, var, total = combine_moments(mesh, xf.numel() // xf.shape[1], mean, var)
        inv_std = torch.rsqrt(var + eps)
        y = (xf - _channel_view(mean, x.dim())) * _channel_view(inv_std * weight, x.dim())
        y = (y + _channel_view(bias, x.dim())).to(x.dtype)
        ctx.save_for_backward(x, mean, inv_std, weight, total)
        ctx.mesh = mesh
        ctx.mark_non_differentiable(mean, var, total)
        return y, mean, var, total

    @staticmethod
    def backward(ctx, grad, *_):
        x, mean, inv_std, weight, total = ctx.saved_tensors
        dims = [0] + list(range(2, x.dim()))
        g = grad.to(torch.float32)
        x_hat = (x.to(torch.float32) - _channel_view(mean, x.dim())) * _channel_view(inv_std, x.dim())
        # float64 accumulation, as one process's BatchNorm accumulates on the CPU
        sum_g, sum_gx = g.sum(dims, dtype=torch.float64), (g * x_hat).sum(dims, dtype=torch.float64)
        sums = ctx.mesh.all_reduce_(torch.cat([sum_g, sum_gx]))
        c = mean.numel()
        mean_g, mean_gx = (sums[:c] / total).to(torch.float32), (sums[c:] / total).to(torch.float32)
        dx = (g - _channel_view(mean_g, x.dim()) - x_hat * _channel_view(mean_gx, x.dim()))
        dx = dx * _channel_view(inv_std * weight, x.dim())
        return dx.to(x.dtype), sum_gx.to(weight.dtype), sum_g.to(weight.dtype), None, None
