"""Eval-mode block 0 of the conv encoder: 3x3 conv over the one input
channel with its BatchNorm folded into weight and bias, max-pool (floor
mode), ReLU.

The JAX package leaves this block to XLA, which fuses it. On the card
``ConvBlock._block`` takes the hand-written kernel (``csrc/block0.cu``, K4)
for an eval-mode block 0 with ``fold_bn_eval`` on a card tensor, and for
nothing else: ``block0_cuda`` reads the
``[B, 1, H, W]`` input once and writes only the pooled ``[B, C, H // ph,
W // pw]`` map, where the plain path writes the full-resolution conv output
and reads it back twice (cuDNN's conv, ATen's bias ``add_``, ``max_pool2d``).

``block0_reference`` is the plain version, the arithmetic ``_block`` runs on
the CPU: ``F.conv2d`` with the bias, ``F.max_pool2d``, ``F.relu``. The
kernel sums in float32, adds the bias in float32 after the max and rounds
once to the activation's dtype; in bf16 the plain path rounds the conv
output before it adds the bias, so the two differ by that one rounding.

``eval.block0_forwards`` and ``eval.block0_kernel_forwards``
(``utils/profiling.py`` counters) count the eval-mode block-0 forwards on the
card and those of them that launched the kernel (``count_block0``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from audio_few_shot_learning_tpu_torch.ops import cuda_build
from audio_few_shot_learning_tpu_torch.utils.profiling import read_counter, set_counter

BLOCK0_FORWARDS = "eval.block0_forwards"
BLOCK0_KERNEL_FORWARDS = "eval.block0_kernel_forwards"
BLOCK0_MAX_THREADS = 256  # csrc/block0.cu kMaxThreads
BLOCK0_MAX_CHANNELS = 256  # kMaxChannels
BLOCK0_UNROLLED_POOL = (3, 3)  # every shipped config's: the patch in registers; any other reads shared memory
WEIGHT_STRIDE = 12  # floats of shared memory a channel: 9 taps, the bias, 2 zeros
SMEM_LIMIT = 227 * 1024
ENTRY = {torch.float32: "afsl_block0_f32", torch.bfloat16: "afsl_block0_bf16"}


def on_card(x: torch.Tensor) -> bool:
    """Whether ``x`` lies on the card (what routes block 0 to the kernel)."""
    return x.is_cuda


def count_block0(kernel: bool) -> None:
    """One eval-mode block-0 forward on the card, which launched the kernel or not."""
    set_counter(BLOCK0_FORWARDS, (read_counter(BLOCK0_FORWARDS) or 0) + 1)
    if kernel:
        set_counter(BLOCK0_KERNEL_FORWARDS, (read_counter(BLOCK0_KERNEL_FORWARDS) or 0) + 1)


def block0_reference(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, pool: Tuple[int, int]) -> torch.Tensor:
    """Plain PyTorch version of K4: ``relu(max_pool2d(conv2d(x, weight, bias,
    padding=1), pool))``, x ``[B, 1, H, W]`` -> ``[B, C, H // ph, W // pw]``."""
    return F.relu(F.max_pool2d(F.conv2d(x, weight, bias, padding=1), tuple(pool)))


@dataclasses.dataclass(frozen=True)
class Block0Plan:
    """K4's launch: one block of ``threads`` per tile of ``tile_rows`` pooled
    rows of one map (``tiles_per_map`` tiles a map, ``blocks`` in all), each
    thread computing ``pair`` neighbouring pooled pixels (2 where the pooled
    width is even at the unrolled pool: vector stores) for every channel,
    ``smem_bytes`` of shared memory a block."""

    pair: int
    tile_rows: int
    tiles_per_map: int
    blocks: int
    threads: int
    smem_bytes: int


def block0_smem_bytes(c: int, tile_rows: int, ph: int, pw: int, wp: int) -> int:
    """Shared memory of one K4 block: the channels' weights, then the tile's
    ``tile_rows * ph + 2`` input rows of ``wp * pw + 2`` floats (the zero
    padding as a border)."""
    return 4 * (c * WEIGHT_STRIDE + (tile_rows * ph + 2) * (wp * pw + 2))


@functools.lru_cache(maxsize=256)  # once per shape: the wrapper plans every call on the host's path
def block0_plan(n_maps: int, h: int, w: int, c: int, ph: int, pw: int) -> Block0Plan:
    """Of the tile heights whose shared memory fits ``SMEM_LIMIT``, the one
    that leaves the fewest idle thread slots over a map (tiles x threads x
    passes against the pixels, pairs counted once), the tallest among equals.
    A block has at most ``BLOCK0_MAX_THREADS`` threads, which loop where a
    tile has more pixels. Raises ValueError when not even one pooled row
    fits shared memory."""
    hp, wp = h // ph, w // pw
    pair = 2 if (ph, pw) == BLOCK0_UNROLLED_POOL and wp % 2 == 0 else 1
    per_row = wp // pair
    best = None
    for rows in range(1, hp + 1):
        smem = block0_smem_bytes(c, rows, ph, pw, wp)
        if smem > SMEM_LIMIT:
            break
        items = rows * per_row
        threads = min(cuda_build.round_up(items, 32), BLOCK0_MAX_THREADS)
        tiles = cuda_build.cdiv(hp, rows)
        slots = tiles * threads * cuda_build.cdiv(items, threads)
        key = (hp * per_row / slots, rows)
        if best is None or key > best[0]:
            best = (key, rows, tiles, threads, smem)
    if best is None:
        need = block0_smem_bytes(c, 1, ph, pw, wp)
        raise ValueError(f"a {h}x{w} map at pool ({ph}, {pw}) needs {need} B of shared memory per block; "
                         f"block 0's kernel takes at most {SMEM_LIMIT} B")
    _, rows, tiles, threads, smem = best
    return Block0Plan(pair=pair, tile_rows=rows, tiles_per_map=tiles, blocks=n_maps * tiles, threads=threads,
                      smem_bytes=smem)


def _check(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, pool: Tuple[int, int]) -> None:
    """Raise on what K4 does not take, before anything reaches the device."""
    if x.dim() != 4 or x.shape[1] != 1:
        raise ValueError(f"block 0's kernel takes x [B, 1, H, W] (one input channel), got {tuple(x.shape)}")
    c = weight.shape[0] if weight.dim() else 0
    if tuple(weight.shape) != (c, 1, 3, 3) or tuple(bias.shape) != (c,):
        raise ValueError(f"block 0's kernel takes a 3x3 kernel over one channel, weight [C, 1, 3, 3] and bias "
                         f"[C], got {tuple(weight.shape)} and {tuple(bias.shape)}")
    if not 1 <= c <= BLOCK0_MAX_CHANNELS:
        raise ValueError(f"block 0's kernel takes 1 to {BLOCK0_MAX_CHANNELS} channels, got {c}")
    if x.dtype not in ENTRY:
        raise TypeError(f"block 0's kernel takes float32 or bfloat16 activations, got {x.dtype}")
    if weight.dtype != x.dtype or bias.dtype != x.dtype:
        raise TypeError(f"block 0's kernel takes weight and bias in the activation's dtype {x.dtype}, "
                        f"got {weight.dtype} and {bias.dtype}")
    if not (x.is_contiguous() and weight.is_contiguous() and bias.is_contiguous()):
        raise ValueError("block 0's kernel takes a contiguous x, weight and bias")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, weight, bias)):
        raise RuntimeError("block 0's kernel has no backward: run the eval forward under torch.inference_mode "
                           "or torch.no_grad")
    ph, pw = pool
    if not (1 <= ph <= x.shape[2] and 1 <= pw <= x.shape[3]):
        raise ValueError(f"pool {tuple(pool)} does not fit a {x.shape[2]}x{x.shape[3]} map")


def block0_cuda(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, pool: Tuple[int, int]) -> torch.Tensor:
    """Launch K4 on CUDA tensors (same contract as ``block0_reference``):
    x ``[B, 1, H, W]`` float32 or bfloat16, weight ``[C, 1, 3, 3]`` and bias
    ``[C]`` in x's dtype (C <= 256), all contiguous, with no gradient to
    record; ``pool`` (ph, pw) no larger than the map, one pooled row's tile
    within shared memory (a map up to ~11 000 frames wide at 64 channels
    and pool 3). Raises on anything else before any launch. The call runs
    K4 and no other device op. Counts the launch in
    ``block0_cuda.launches``."""
    _check(x, weight, bias, pool)
    b, _, h, w = x.shape
    c = weight.shape[0]
    ph, pw = pool
    plan = block0_plan(b, h, w, c, ph, pw)
    if not all(t.is_cuda and t.device == x.device for t in (x, weight, bias)):
        raise ValueError("block0_cuda needs CUDA tensors on one device")
    out = torch.empty((b, c, h // ph, w // pw), device=x.device, dtype=x.dtype)
    if b == 0:
        return out
    fn = cuda_build.function("block0", ENTRY[x.dtype], [ctypes.c_void_p] * 4 + [ctypes.c_int] * 11 + [ctypes.c_void_p])
    status = fn(
        cuda_build.ptr(x), cuda_build.ptr(weight), cuda_build.ptr(bias), cuda_build.ptr(out),
        b, h, w, c, ph, pw, plan.tile_rows, plan.tiles_per_map, plan.threads, plan.pair, plan.smem_bytes,
        cuda_build.stream_handle(x.device),
    )
    cuda_build.check_launch(status, "block 0 kernel")
    block0_cuda.launches += 1
    return out


block0_cuda.launches = 0
