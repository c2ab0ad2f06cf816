"""Eval-mode conv blocks of the conv encoder on the card: 3x3 conv with its
BatchNorm folded into weight and bias, max-pool (floor mode), ReLU, in one
pass that never writes the full-resolution map.

The JAX package leaves these blocks to XLA, which fuses them. On the card
``ConvBlock._block`` takes two hand-written kernels, for eval-mode blocks
with ``fold_bn_eval`` on a card tensor and for nothing else:

* K4 (``csrc/block0.cu``, ``block0_cuda``): block 0, over the one input
  channel, float32 FMAs, in float32 or bfloat16. It reads the
  ``[B, 1, H, W]`` input once and writes only the pooled
  ``[B, C, H // ph, W // pw]`` map, channels-last (``torch.channels_last``:
  the same shape and values, NHWC strides), where the plain path writes the
  full-resolution conv output and reads it back twice (cuDNN's conv, ATen's
  bias ``add_``, ``max_pool2d``).
* K5 (``csrc/convblocks.cu``, ``blocks_cuda``): blocks 1-3, C input and C
  output channels, an implicit-GEMM conv on the tensor cores with the pool,
  bias and ReLU in its epilogue, in bfloat16 only. It reads the channels-last
  map K4 or its own previous launch wrote and writes the pooled map
  channels-last. A float32 eval keeps cuDNN's path for these blocks (TF32
  off): on the tensor cores float32 would mean TF32, a lower precision than
  such a config states.

``block0_reference`` and ``blocks_reference`` are the plain versions, the
arithmetic ``_block`` runs on the CPU: ``F.conv2d`` with the bias,
``F.max_pool2d``, ``F.relu``. The kernels sum in float32, add the bias in
float32 after the max and round once to the activation's dtype; in bf16
the plain path rounds the conv output before it adds the bias, so the two
differ by that one rounding.

Counters (``utils/profiling.py``): ``eval.block0_forwards`` and
``eval.block0_kernel_forwards`` count the eval-mode block-0 forwards on the
card and those of them that launched K4 (``count_block0``);
``eval.blocks123_forwards`` and ``eval.blocks123_kernel_forwards`` the
eval-mode forwards on the card of a block with as many input as output
channels (blocks 1-3) and those that launched K5 (``count_blocks``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Tuple

import torch
import torch.nn.functional as F

from audio_few_shot_learning_tpu_torch.ops import cuda_build
from audio_few_shot_learning_tpu_torch.utils.profiling import read_counter, set_counter

BLOCK0_FORWARDS = "eval.block0_forwards"
BLOCK0_KERNEL_FORWARDS = "eval.block0_kernel_forwards"
BLOCKS_FORWARDS = "eval.blocks123_forwards"
BLOCKS_KERNEL_FORWARDS = "eval.blocks123_kernel_forwards"
BLOCK0_MAX_THREADS = 256  # csrc/block0.cu kMaxThreads
BLOCK0_MAX_CHANNELS = 256  # kMaxChannels
BLOCK0_UNROLLED_POOL = (3, 3)  # every shipped config's: the patch in registers; any other reads shared memory
BLOCK0_VEC = 8  # kVec: channels a thread stores at once; the weights are padded to a multiple
WEIGHT_STRIDE = 12  # floats of shared memory a channel: 9 taps, the bias, 2 zeros
SMEM_LIMIT = 227 * 1024
ENTRY = {torch.float32: "afsl_block0_f32", torch.bfloat16: "afsl_block0_bf16"}
# csrc/convblocks.cu: 64 channels computed (fewer padded with zeros), their
# 576 x 64 bf16 weights in shared memory, then the ring's barriers and the
# stages; two teams of four warps, each taking tiles of at most 32 pooled
# pixels (2 x 16 pixels x 2 x 32 channels)
BLOCKS_CHANNELS = 64
BLOCKS_WEIGHT_BYTES = 9 * BLOCKS_CHANNELS * BLOCKS_CHANNELS * 2
BLOCKS_PIXEL_BYTES = BLOCKS_CHANNELS * 2
BLOCKS_RING_HEADER = 1024  # kRingHeader: the stages' barriers; stages 1024-byte aligned for the swizzle
BLOCKS_STAGE_BASE = BLOCKS_WEIGHT_BYTES + BLOCKS_RING_HEADER
BLOCKS_TEAM_PX = 32
BLOCKS_MAX_POOL = 3
BLOCKS_MAX_BOX = 256  # input pixels a slot's copy may hold (a tensor copy's box)
# how a launch cuts the pooled pixels into tiles: runs of the concatenated
# maps, or rectangles within a map
RUNS, RECTS = 0, 1
H100_SMS = 132


def on_card(x: torch.Tensor) -> bool:
    """Whether ``x`` lies on the card (what routes a block to its kernel)."""
    return x.is_cuda


def count_block0(kernel: bool) -> None:
    """One eval-mode block-0 forward on the card, which launched the kernel or not."""
    set_counter(BLOCK0_FORWARDS, (read_counter(BLOCK0_FORWARDS) or 0) + 1)
    if kernel:
        set_counter(BLOCK0_KERNEL_FORWARDS, (read_counter(BLOCK0_KERNEL_FORWARDS) or 0) + 1)


def count_blocks(kernel: bool) -> None:
    """One eval-mode forward on the card of a block of C input and C output
    channels (blocks 1-3), which launched K5 or not."""
    set_counter(BLOCKS_FORWARDS, (read_counter(BLOCKS_FORWARDS) or 0) + 1)
    if kernel:
        set_counter(BLOCKS_KERNEL_FORWARDS, (read_counter(BLOCKS_KERNEL_FORWARDS) or 0) + 1)


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
    """Shared memory of one K4 block: the weights of the channels rounded up
    to ``BLOCK0_VEC`` (zeros past C), then the tile's ``tile_rows * ph + 2``
    input rows of ``wp * pw + 2`` floats (the zero padding as a border)."""
    return 4 * (cuda_build.round_up(c, BLOCK0_VEC) * WEIGHT_STRIDE + (tile_rows * ph + 2) * (wp * pw + 2))


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
    and pool 3). Raises on anything else before any launch. The output is
    channels-last (``torch.channels_last``). The call runs K4 and no other
    device op. Counts the launch in ``block0_cuda.launches``."""
    _check(x, weight, bias, pool)
    b, _, h, w = x.shape
    c = weight.shape[0]
    ph, pw = pool
    plan = block0_plan(b, h, w, c, ph, pw)
    if not all(t.is_cuda and t.device == x.device for t in (x, weight, bias)):
        raise ValueError("block0_cuda needs CUDA tensors on one device")
    out = torch.empty((b, c, h // ph, w // pw), device=x.device, dtype=x.dtype, memory_format=torch.channels_last)
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


def blocks_reference(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, pool: Tuple[int, int]) -> torch.Tensor:
    """Plain PyTorch version of K5: ``relu(max_pool2d(conv2d(x, weight, bias,
    padding=1), pool))``, x ``[B, C, H, W]`` -> ``[B, C, H // ph, W // pw]``."""
    return F.relu(F.max_pool2d(F.conv2d(x, weight, bias, padding=1), tuple(pool)))


@dataclasses.dataclass(frozen=True)
class BlocksPlan:
    """K5's launch: ``tiles`` tiles of at most 32 pooled pixels, runs of
    ``tile_px`` of the concatenated maps (``mode`` ``RUNS``) or rectangles
    within a map (``RECTS``: ``rr`` x ``rc`` pooled rows x columns, and a
    right strip of the remaining ``wp % rc`` columns in rectangles of ``sr``
    rows), taken in turn by two teams in each of ``ctas`` persistent blocks
    through a ring of ``stages`` buffers of ``stage_bytes`` (with 3 a tile's
    copy is issued well before it is computed; with 2 a team copies, then
    computes); a run's slots lie ``pitch`` input pixels apart in shared
    memory (a rectangle's: its width); ``smem_bytes`` holds the weights, the
    ring and the stages; ``useful`` is the share of the teams' 32-pixel
    capacity the tiles fill."""

    mode: int
    tile_px: int
    rr: int
    rc: int
    sr: int
    pitch: int
    stages: int
    stage_bytes: int
    tiles: int
    ctas: int
    smem_bytes: int
    useful: float


def stage_limit(stages: int) -> int:
    """The bytes a stage may hold with ``stages`` of them beside the weights
    and the ring, in whole KiB (each stage starts 1024-byte aligned)."""
    return (SMEM_LIMIT - BLOCKS_STAGE_BASE) // stages // 1024 * 1024


def slot_pitch(cols: int, ph: int, pw: int) -> int:
    """Input pixels from one slot to the next in shared memory for runs of
    maps ``cols`` pooled pixels wide. The 128-byte swizzle puts chunk j of the
    stage's pixel p at chunk j ^ (p & 7), and an ldmatrix reads 8
    consecutive pooled pixels of a tile (p, p + pw, ..): the smallest pitch
    from ``pw * cols + 2`` up that steps p by ``pw`` (mod 8) also where the
    8 wrap to the next pooled row (ph slots down, ``pw * (cols - 1)``
    columns back) keeps them in 8 banks. Tiles whose rows are a multiple of
    8 wide never wrap inside such 8."""
    width = pw * cols + 2
    if cols % 8 == 0:
        return width
    return next((p for p in range(width, width + 8) if (ph * p - pw * cols) % 8 == 0), width)


def _slots_bytes(rows: int, cols: int, pitch: int, ph: int) -> int:
    """A single-map tile of ``rows`` pooled rows: ``ph * rows + 2`` slots at
    ``pitch`` input pixels each."""
    return (ph * rows + 2) * pitch * BLOCKS_PIXEL_BYTES


def tile_geometry(t: int, plan: BlocksPlan, hp: int, wp: int, ph: int, pw: int, total: int) -> dict:
    """Tile ``t`` and the input it reads, as K5 holds it (``csrc/convblocks.cu::
    tile_of``): ``n`` pooled pixels, a run from ``q0`` (``cols`` 0) or a
    rectangle of ``cols`` columns from ``col_lo`` and rows from ``lo0`` of map
    ``m0``; ``slots`` input rows, each ``width`` input pixels wide from
    pooled column ``col_lo``, the first map's ``rows0`` from pooled row
    ``lo0``, each later one's ``ph * hp + 2`` from input row -1 but the
    last, which stops after its last pooled row."""
    hwp = hp * wp
    if plan.mode == RECTS:
        n_mc = wp // plan.rc
        n_main = cuda_build.cdiv(hp, plan.rr) * n_mc
        strip = wp - n_mc * plan.rc
        per_map = n_main + (cuda_build.cdiv(hp, plan.sr) if strip else 0)
        m0, k = divmod(t, per_map)
        if k < n_main:
            bi, bj = divmod(k, n_mc)
            lo0, col_lo, cols, rows = bi * plan.rr, bj * plan.rc, plan.rc, min(plan.rr, hp - bi * plan.rr)
        else:
            k -= n_main
            lo0, col_lo, cols, rows = k * plan.sr, n_mc * plan.rc, strip, min(plan.sr, hp - k * plan.sr)
        return dict(q0=m0 * hwp, m0=m0, n=rows * cols, cols=cols, lo0=lo0, col_lo=col_lo, width=pw * cols + 2,
                    pitch=pw * cols + 2, rows0=ph * rows + 2, slots=ph * rows + 2)
    q0 = t * plan.tile_px
    n = min(plan.tile_px, total - q0)
    m0, r0 = divmod(q0, hwp)
    m1, r1 = divmod(q0 + n - 1, hwp)
    lo0, hi1 = r0 // wp, r1 // wp
    if m1 == m0:
        rows0 = slots = ph * (hi1 - lo0 + 1) + 2
    else:
        rows0 = ph * (hp - lo0) + 2
        slots = rows0 + (m1 - m0 - 1) * (ph * hp + 2) + ph * (hi1 + 1) + 2
    return dict(q0=q0, m0=m0, n=n, cols=0, lo0=lo0, col_lo=0, width=pw * wp + 2, pitch=plan.pitch, rows0=rows0,
                slots=slots)


def tile_pixel(g: dict, r: int, hp: int, wp: int) -> Tuple[int, int, int]:
    """Pixel ``r`` of tile ``g``: its map, pooled row and column (``pixel_of``)."""
    if g["cols"]:
        return g["m0"], g["lo0"] + r // g["cols"], g["col_lo"] + r % g["cols"]
    m, rem = divmod(g["q0"] + r, hp * wp)
    return (m, *divmod(rem, wp))


def _runs_bytes(tile_px: int, hp: int, wp: int, ph: int, pw: int, pitch: int) -> int:
    """The largest run's slots in bytes, over one period of the runs' pattern
    (runs whose maps never end: a run cut short at the last map reads a
    part of what the full one would)."""
    hwp = hp * wp
    probe = BlocksPlan(RUNS, tile_px, 0, 0, 0, pitch, 2, 0, 0, 0, 0, 0.0)
    worst = 0
    for t in range(hwp // math.gcd(tile_px, hwp)):
        g = tile_geometry(t, probe, hp, wp, ph, pw, total=(t + 1) * tile_px)
        worst = max(worst, g["slots"] * g["pitch"] * BLOCKS_PIXEL_BYTES)
    return worst


def _stages(stage_bytes: int):
    """3 stages where they fit shared memory, else 2, else None."""
    return next((st for st in (3, 2) if stage_bytes <= stage_limit(st)), None)


@functools.lru_cache(maxsize=256)  # once per shape: the wrapper plans every call on the host's path
def blocks_plan(n_maps: int, h: int, w: int, ph: int, pw: int, sms: int = H100_SMS) -> BlocksPlan:
    """Of the tilings (runs of 32 or 16 across maps; rectangles of 32 pooled
    pixels, 16 or 32 columns or the map's width, with a right strip) whose
    largest tile fits a stage, the one with the fewest tiles, a tile counted
    half again where only two stages fit (its copy is then not hidden), the
    three-stage one and then runs among equals. A run of 16 across maps
    always fits two stages (pools up to 3x3)."""
    hp, wp = h // ph, w // pw
    total = n_maps * hp * wp
    # (mode, tile_px, rr, rc, sr, a run's pitch, the largest tile's slot
    # bytes, tiles); a run's slots are whole rows, at most 256 input pixels
    # (one copy's box), a copy each, with the seamless pitch (slot_pitch)
    # where that keeps the stages, else with its slots' width
    shapes = []
    if pw * wp + 2 <= BLOCKS_MAX_BOX:
        for tile_px in (BLOCKS_TEAM_PX, BLOCKS_TEAM_PX // 2):
            options = [(p, _runs_bytes(tile_px, hp, wp, ph, pw, p)) for p in (slot_pitch(wp, ph, pw), pw * wp + 2)]
            pitch, worst = max(options, key=lambda o: _stages(cuda_build.round_up(o[1], 1024)) or 0)
            shapes.append((RUNS, tile_px, 0, 0, 0, pitch, worst, cuda_build.cdiv(total, tile_px)))
    # a rectangle is one copy of all its slots' rows, ``pw * cols + 2`` apart
    for rc in sorted({c for c in (8, 16, 32) if c <= wp} | ({wp} if wp < BLOCKS_TEAM_PX else set())):
        rr = min(BLOCKS_TEAM_PX // rc, hp)
        strip = wp % rc
        main = _slots_bytes(rr, rc, pw * rc + 2, ph)
        for stages in (3, 2):
            # the strip's rectangles: as many rows as fit 32 pixels and a stage
            sr = min(BLOCKS_TEAM_PX // strip, hp) if strip else 0
            while sr > 1 and _slots_bytes(sr, strip, pw * strip + 2, ph) > stage_limit(stages):
                sr -= 1
            worst = max(main, _slots_bytes(sr, strip, pw * strip + 2, ph) if strip else 0)
            if worst <= stage_limit(stages):
                tiles = n_maps * (cuda_build.cdiv(hp, rr) * (wp // rc) + (cuda_build.cdiv(hp, sr) if strip else 0))
                shapes.append((RECTS, 0, rr, rc, sr, 0, worst, tiles))
                break
    best = None
    for mode, tile_px, rr, rc, sr, pitch, worst, tiles in shapes:
        stage_bytes = cuda_build.round_up(worst, 1024)
        stages = _stages(stage_bytes)
        if stages is None:
            continue
        key = (tiles * (1.0 if stages == 3 else 1.5), -stages, mode)
        if best is None or key < best[0]:
            best = (key, BlocksPlan(mode=mode, tile_px=tile_px, rr=rr, rc=rc, sr=sr, pitch=pitch, stages=stages,
                                    stage_bytes=stage_bytes, tiles=tiles, ctas=min(cuda_build.cdiv(tiles, 2), sms),
                                    smem_bytes=BLOCKS_STAGE_BASE + stages * stage_bytes,
                                    useful=total / (tiles * BLOCKS_TEAM_PX)))
    return best[1]


def _check_blocks(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, pool: Tuple[int, int]) -> None:
    """Raise on what K5 does not take, before anything reaches the device."""
    if x.dim() != 4:
        raise ValueError(f"the kernel of blocks 1-3 takes x [B, C, H, W], got {tuple(x.shape)}")
    c = x.shape[1]
    if tuple(weight.shape) != (c, c, 3, 3) or tuple(bias.shape) != (c,):
        raise ValueError(f"the kernel of blocks 1-3 takes a 3x3 kernel from C to C channels, weight [C, C, 3, 3] "
                         f"and bias [C] with C = {c}, got {tuple(weight.shape)} and {tuple(bias.shape)}")
    if c % 8 or not 8 <= c <= BLOCKS_CHANNELS:
        raise ValueError(f"the kernel of blocks 1-3 takes 8 to {BLOCKS_CHANNELS} channels, a multiple of 8, got {c}")
    if any(t.dtype != torch.bfloat16 for t in (x, weight, bias)):
        raise TypeError(f"the kernel of blocks 1-3 takes bfloat16 x, weight and bias, got {x.dtype}, "
                        f"{weight.dtype} and {bias.dtype}")
    if not x.is_contiguous(memory_format=torch.channels_last) or x.data_ptr() % 16:
        raise ValueError("the kernel of blocks 1-3 takes a channels-last x (torch.channels_last), 16-byte aligned")
    if not (weight.is_contiguous() and bias.is_contiguous()):
        raise ValueError("the kernel of blocks 1-3 takes a contiguous weight and bias")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, weight, bias)):
        raise RuntimeError("the kernel of blocks 1-3 has no backward: run the eval forward under "
                           "torch.inference_mode or torch.no_grad")
    ph, pw = pool
    if not (1 <= ph <= BLOCKS_MAX_POOL and 1 <= pw <= BLOCKS_MAX_POOL):
        raise ValueError(f"the kernel of blocks 1-3 takes pools up to {BLOCKS_MAX_POOL}x{BLOCKS_MAX_POOL}, "
                         f"got {tuple(pool)}")
    if ph > x.shape[2] or pw > x.shape[3]:
        raise ValueError(f"pool {tuple(pool)} does not fit a {x.shape[2]}x{x.shape[3]} map")


def blocks_cuda(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, pool: Tuple[int, int]) -> torch.Tensor:
    """Launch K5 on CUDA tensors (same contract as ``blocks_reference``):
    x ``[B, C, H, W]`` bfloat16 and channels-last, weight ``[C, C, 3, 3]``
    and bias ``[C]`` bfloat16 and contiguous, 8 <= C <= 64 a multiple of 8,
    with no gradient to record; ``pool`` (ph, pw) at most 3x3 and no larger
    than the map. Raises on anything else before any launch. The output is
    channels-last. The call runs K5 and no other device op. Counts the
    launch in ``blocks_cuda.launches``."""
    _check_blocks(x, weight, bias, pool)
    b, c, h, w = x.shape
    ph, pw = pool
    if not all(t.is_cuda and t.device == x.device for t in (x, weight, bias)):
        raise ValueError("blocks_cuda needs CUDA tensors on one device")
    out = torch.empty((b, c, h // ph, w // pw), device=x.device, dtype=x.dtype, memory_format=torch.channels_last)
    if b == 0:
        return out
    plan = blocks_plan(b, h, w, ph, pw, _sms(x.device))
    fn = cuda_build.function("convblocks", "afsl_blocks_bf16",
                             [ctypes.c_void_p] * 4 + [ctypes.c_int] * 14 + [ctypes.c_longlong]
                             + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    status = fn(
        cuda_build.ptr(x), cuda_build.ptr(weight), cuda_build.ptr(bias), cuda_build.ptr(out),
        b, h, w, c, ph, pw, plan.mode, plan.tile_px, plan.rr, plan.rc, plan.sr, plan.pitch, plan.stages,
        plan.stage_bytes, plan.tiles, plan.ctas, plan.smem_bytes, cuda_build.stream_handle(x.device),
    )
    cuda_build.check_launch(status, "conv blocks kernel")
    blocks_cuda.launches += 1
    return out


blocks_cuda.launches = 0


@functools.lru_cache(maxsize=16)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count
