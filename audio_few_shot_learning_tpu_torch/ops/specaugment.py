"""SpecAugment on the device, producing the reference's fixed 4-view expansion.

Counterpart of the JAX package's ``ops/specaugment.py``. From one batch of
spectrograms produce ``[original, time_warp, time_mask, freq_mask]``, each
augmentation applied to a fresh copy of the original. Mask draws are shared
across the items of one call (per episode); the time-warp control points are
drawn per item.

Randomness is data here: ``draw_views_params`` turns a ``torch.Generator``
into ``(ys, tmask, fmask)`` and every other function is deterministic in
those, so tests can hand the same draws to this package and the JAX one.

``spec_augment_views`` takes the plain version (``views_reference``) for a
CPU tensor and launches the fused kernel (``csrc/specaugment.cu``, K1) for a
CUDA tensor: one read of the input, four writes.

Layouts follow the JAX package: specs ``[B, F, T]`` -> views
``[B, 4, F, T]``, or with a leading episode axis ``[E, B, F, T]`` ->
``[E, B, 4, F, T]`` with per-episode masks.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Optional, Tuple

import torch

from audio_few_shot_learning_tpu_torch.config import SpecAugParams
from audio_few_shot_learning_tpu_torch.ops import cuda_build
from audio_few_shot_learning_tpu_torch.utils.profiling import spanned

NUM_VIEWS = 4
Draws = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # ys, tmask, fmask


def hermite_warp_positions(warp_p: torch.Tensor, warp_d: torch.Tensor, t_len: int) -> torch.Tensor:
    """Source positions (normalized [-1, 1]) of the time warp for control
    draws ``warp_p``, ``warp_d`` (any shape ``[...]``) -> ``[..., t_len]``.

    Control points x = [0, warp_p, T-1], y = [-1, (warp_p-warp_d)*2/(T-1)-1, 1]
    with finite-difference tangents, evaluated at xs = 0..T-1.
    """
    warp_p = warp_p.to(torch.float32)[..., None]
    warp_d = warp_d.to(torch.float32)[..., None]
    x0, x1, x2 = 0.0, warp_p, float(t_len - 1)
    y0 = -1.0
    y1 = (warp_p - warp_d) * 2.0 / (t_len - 1) - 1.0
    y2 = 1.0

    m0 = (y1 - y0) / (x1 - x0)
    m1 = (y2 - y1) / (x2 - x1)
    mm = (m0 + m1) * 0.5

    xs = torch.arange(t_len, dtype=torch.float32, device=warp_p.device)
    in_second = xs > warp_p

    xa = torch.where(in_second, x1, x0)
    xb = torch.where(in_second, x2, x1)
    ya = torch.where(in_second, y1, y0)
    yb = torch.where(in_second, y2, y1)
    ma = torch.where(in_second, mm, m0)
    mb = torch.where(in_second, m1, mm)

    dx = xb - xa
    t = (xs - xa) / dx
    h00 = (1.0 + 2.0 * t) * (1.0 - t) ** 2
    h10 = t * (1.0 - t) ** 2
    h01 = t * t * (3.0 - 2.0 * t)
    h11 = t * t * (t - 1.0)
    return h00 * ya + h10 * ma * dx + h01 * yb + h11 * mb * dx


def _uniform_int(gen: torch.Generator, low: torch.Tensor, high: torch.Tensor) -> torch.Tensor:
    """Uniform integers in [low, high) with per-element bounds (high > low)."""
    u = torch.rand(low.shape, generator=gen, device=low.device)
    span = high - low
    return low + torch.minimum((u * span).floor().long(), span - 1)


def _mask_bounds(gen, shape, max_len: int, length: int, device):
    """Interval draws ``w ~ U[1, max_len]``, ``w0 ~ U[0, max(length - w, 1))``;
    returns ``(lo, hi) = (w0, w0 + w)``, each of ``shape``."""
    w = torch.randint(1, max_len + 1, shape, generator=gen, device=device)
    zero = torch.zeros_like(w)
    w0 = _uniform_int(gen, zero, (length - w).clamp_min(1))
    return w0, w0 + w


def mask_bounds_freq(gen, shape, num_mask: int, mask_param: int, f_len: int, device):
    """``num_mask`` frequency-mask intervals per entry of ``shape``: f ~ U[1,
    mask_param], f0 ~ U[0, F-f-1]. Returns (lo, hi) of ``shape + (num_mask,)``."""
    return _mask_bounds(gen, tuple(shape) + (num_mask,), mask_param, f_len, device)


def mask_bounds_time(gen, shape, num_mask: int, mask_param: int, p: float, t_len: int, device):
    """Time-mask intervals: t ~ U[1, min(mask_param, int(p*T))], t0 ~ U[0, T-t-1]."""
    max_len = max(min(mask_param, int(p * t_len)), 1)
    return _mask_bounds(gen, tuple(shape) + (num_mask,), max_len, t_len, device)


def interval_mask(lo: torch.Tensor, hi: torch.Tensor, length: int) -> torch.Tensor:
    """OR of [lo_i, hi_i) intervals: lo, hi ``[..., M]`` -> bool ``[..., length]``."""
    idx = torch.arange(length, device=lo.device)
    return ((idx >= lo[..., None]) & (idx < hi[..., None])).any(dim=-2)


@spanned("afsl.draws")
def draw_views_params(
    gen: torch.Generator,
    params: SpecAugParams,
    n_episodes: int,
    n_items: int,
    f_len: int,
    t_len: int,
    device,
) -> Draws:
    """Random draws of one ``spec_augment_views`` call per episode:
    ys ``[E, B, T]`` (per item), tmask ``[E, T]`` and fmask ``[E, F]`` (per episode)."""
    e = (n_episodes,)
    tlo, thi = mask_bounds_time(gen, e, params.num_mask, params.mask_param, params.p, t_len, device)
    flo, fhi = mask_bounds_freq(gen, e, params.num_mask, params.mask_param, f_len, device)
    ys = draw_warp_positions(gen, (n_episodes, n_items), t_len, params.W, device)
    return ys, interval_mask(tlo, thi, t_len), interval_mask(flo, fhi, f_len)


def draw_warp_positions(gen: torch.Generator, shape: Tuple[int, ...], t_len: int, w: int, device) -> torch.Tensor:
    """Per-item time-warp source positions ``shape + [T]``: the control
    point ``warp_p ~ U[w, T-w)`` and shift ``warp_d ~ U[-w, w)`` of each
    item, through the Hermite curve."""
    warp_p = torch.randint(w, t_len - w, shape, generator=gen, device=device)
    warp_d = torch.randint(-w, w, shape, generator=gen, device=device)
    return hermite_warp_positions(warp_p, warp_d, t_len)


def warp_gather(spec: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
    """Bilinear time warp as a two-tap gather along T (grid_sample with
    align_corners=True, zero padding). spec ``[..., F, T]``, ys ``[..., T]``."""
    t_len = spec.shape[-1]
    src = (ys + 1.0) * 0.5 * (t_len - 1)
    s0 = torch.floor(src)
    w1 = src - s0
    w0 = 1.0 - w1
    s1 = s0 + 1.0
    w0 = torch.where((s0 >= 0) & (s0 <= t_len - 1), w0, 0.0)[..., None, :]
    w1 = torch.where((s1 >= 0) & (s1 <= t_len - 1), w1, 0.0)[..., None, :]
    i0 = s0.clamp(0, t_len - 1).long()[..., None, :].expand(spec.shape)
    i1 = s1.clamp(0, t_len - 1).long()[..., None, :].expand(spec.shape)
    g0 = torch.gather(spec, -1, i0).to(torch.float32)
    g1 = torch.gather(spec, -1, i1).to(torch.float32)
    return (w0 * g0 + w1 * g1).to(spec.dtype)


def time_warp(spec: torch.Tensor, gen: torch.Generator, w: int) -> torch.Tensor:
    """Per-item Hermite time warp ``[..., F, T] -> [..., F, T]`` (JAX
    ``time_warp``, ops/specaugment.py:124), its control points drawn from
    ``gen``, which lives on ``spec``'s device: the warp view of K1's 4."""
    ys = draw_warp_positions(gen, tuple(spec.shape[:-2]), spec.shape[-1], w, spec.device)
    return warp_gather(spec, ys)


def views_reference(spec, ys, tmask, fmask, mask_value: float) -> torch.Tensor:
    """Plain PyTorch version of K1 (= ``_views_xla``): spec ``[E, B, F, T]``,
    ys ``[E, B, T]``, tmask ``[E, T]``, fmask ``[E, F]`` -> ``[E, B, 4, F, T]``."""
    warped = warp_gather(spec, ys)
    tview = spec.masked_fill(tmask[:, None, None, :], mask_value)
    fview = spec.masked_fill(fmask[:, None, :, None], mask_value)
    return torch.stack([spec, warped, tview, fview], dim=2)


VIEWS_MAX_THREADS = 256  # csrc/specaugment.cu kMaxThreads
VIEWS_TILES_PER_SM = 4  # the least tiles a launch leaves each SM, where the shape has them
SMEM_LIMIT = 227 * 1024  # Hopper: dynamic shared memory one block may take
ACCESS_BYTES = 16


@dataclasses.dataclass(frozen=True)
class ViewsPlan:
    """K1's launch: one block of ``threads`` per tile of ``rows`` spectrogram
    rows of one item (``tiles_per_item`` tiles an item, ``blocks`` in all),
    each thread moving ``vec`` elements per access (16 bytes on the vector
    path, 1 on the scalar one), ``smem_bytes`` of shared memory a block."""

    vec: int
    rows: int
    tiles_per_item: int
    blocks: int
    threads: int
    smem_bytes: int


def _padded(nbytes: int) -> int:
    """A shared buffer with one 4-byte word after every 128 bytes (and one
    spare): ``csrc/specaugment.cu`` padded_bytes."""
    return nbytes + 4 * (nbytes // 128 + 1)


def views_smem_bytes(rows: int, t_len: int, elem_bytes: int) -> int:
    """Shared memory of one K1 block: the item's ys row (f32), then from the
    next 16-byte boundary the tile of ``rows`` x T elements, both padded."""
    return cuda_build.round_up(_padded(4 * t_len), ACCESS_BYTES) + _padded(rows * t_len * elem_bytes)


@functools.lru_cache(maxsize=256)  # once per shape: the wrapper plans every call on the host's path
def views_plan(
    n_episodes: int, n_items: int, f_len: int, t_len: int, elem_bytes: int, sm_count: int, aligned: bool = True
) -> ViewsPlan:
    """The vector path (16-byte accesses) where every span starts on a
    16-byte boundary: ``aligned`` bases, a plane of whole 16-byte units and
    tiles of a row count whose span is whole 16-byte units; else one
    element per access. Of the row counts whose tile fits ``SMEM_LIMIT``
    and one access per thread (``VIEWS_MAX_THREADS``), the most that still
    leave ``VIEWS_TILES_PER_SM`` tiles per SM, or the fewest when none does.
    Raises ValueError when not even one row fits shared memory."""
    plane = f_len * t_len * elem_bytes
    vec = ACCESS_BYTES // elem_bytes if aligned and plane % ACCESS_BYTES == 0 else 1
    step = ACCESS_BYTES // math.gcd(t_len * elem_bytes, ACCESS_BYTES) if vec > 1 else 1
    counts = list(range(step, f_len + 1, step)) or [f_len]  # step > F: one tile an item
    fits = [r for r in counts if views_smem_bytes(r, t_len, elem_bytes) <= SMEM_LIMIT]
    if not fits:
        need = views_smem_bytes(counts[0], t_len, elem_bytes)
        raise ValueError(f"T={t_len} needs {need} B of shared memory per block; K1 takes at most {SMEM_LIMIT} B")
    one_each = [r for r in fits if cuda_build.cdiv(r * t_len, vec) <= VIEWS_MAX_THREADS] or fits[:1]
    items = n_episodes * n_items
    filled = [r for r in one_each if items * cuda_build.cdiv(f_len, r) >= VIEWS_TILES_PER_SM * sm_count]
    rows = max(filled) if filled else one_each[0]
    tiles = cuda_build.cdiv(f_len, rows)
    threads = min(cuda_build.round_up(cuda_build.cdiv(rows * t_len, vec), 32), VIEWS_MAX_THREADS)
    return ViewsPlan(vec=vec, rows=rows, tiles_per_item=tiles, blocks=items * tiles, threads=threads,
                     smem_bytes=views_smem_bytes(rows, t_len, elem_bytes))


def _mask_bytes(mask: torch.Tensor, name: str) -> torch.Tensor:
    """A bool mask as the kernel reads it: the same bytes as ``uint8``, a
    view (no copy, no device op). Raises on what the kernel does not take."""
    if mask.dtype != torch.bool or not mask.is_contiguous():
        raise ValueError(f"{name} must be a contiguous bool tensor, got {mask.dtype} with strides {mask.stride()}")
    return mask.view(torch.uint8)


def views_cuda(spec, ys, tmask, fmask, mask_value: float) -> torch.Tensor:
    """Launch K1 on CUDA tensors (same contract as ``views_reference``):
    spec ``[E, B, F, T]`` float32 or bfloat16, ys ``[E, B, T]`` float32,
    bool tmask ``[E, T]`` and fmask ``[E, F]``, all contiguous; the call
    runs K1 and no other device op. Counts the launch in
    ``views_cuda.launches``."""
    if spec.dim() != 4:
        raise ValueError(f"spec must be [E, B, F, T], got {tuple(spec.shape)}")
    e, b, f_len, t_len = spec.shape
    if tuple(ys.shape) != (e, b, t_len) or tuple(tmask.shape) != (e, t_len) or tuple(
        fmask.shape
    ) != (e, f_len):
        raise ValueError(
            f"draws do not match spec {tuple(spec.shape)}: ys {tuple(ys.shape)}, "
            f"tmask {tuple(tmask.shape)}, fmask {tuple(fmask.shape)}"
        )
    if not all(t.is_cuda and t.device == spec.device for t in (spec, ys, tmask, fmask)):
        raise ValueError("views_cuda needs CUDA tensors on one device")
    entry = {torch.float32: "afsl_specaugment_views_f32", torch.bfloat16: "afsl_specaugment_views_bf16"}
    if spec.dtype not in entry:
        raise TypeError(f"SpecAugment kernel takes float32 or bfloat16 specs, got {spec.dtype}")
    if ys.dtype != torch.float32:
        raise TypeError(f"SpecAugment kernel takes float32 warp positions, got {ys.dtype}")
    if not (spec.is_contiguous() and ys.is_contiguous()):
        raise ValueError("SpecAugment kernel takes a contiguous spec and ys")
    tm, fm = _mask_bytes(tmask, "tmask"), _mask_bytes(fmask, "fmask")
    out = torch.empty((e, b, NUM_VIEWS, f_len, t_len), device=spec.device, dtype=spec.dtype)
    if out.numel() == 0:
        return out
    sm_count = torch.cuda.get_device_properties(spec.device).multi_processor_count
    plan = views_plan(e, b, f_len, t_len, spec.element_size(), sm_count, spec.data_ptr() % ACCESS_BYTES == 0)
    fn = cuda_build.function(
        "specaugment",
        entry[spec.dtype],
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_float] + [ctypes.c_int] * 5 + [ctypes.c_void_p],
    )
    status = fn(
        cuda_build.ptr(spec), cuda_build.ptr(ys), cuda_build.ptr(tm), cuda_build.ptr(fm),
        cuda_build.ptr(out), e, b, f_len, t_len, float(mask_value),
        plan.rows, plan.tiles_per_item, plan.threads, plan.vec, plan.smem_bytes,
        cuda_build.stream_handle(spec.device),
    )
    cuda_build.check_launch(status, "SpecAugment kernel")
    views_cuda.launches += 1
    return out


views_cuda.launches = 0


def spec_augment_views(
    spec: torch.Tensor,
    gen: Optional[torch.Generator],
    params: SpecAugParams,
    draws: Optional[Draws] = None,
) -> torch.Tensor:
    """``[B, F, T] -> [B, 4, F, T]`` (or ``[E, B, F, T] -> [E, B, 4, F, T]``
    with per-episode masks): original, warp, time mask, freq mask.

    ``draws = (ys, tmask, fmask)`` fixes the randomness (shapes as
    ``draw_views_params`` gives, without the E axis for an unbatched spec);
    otherwise they are drawn from ``gen``, which must live on ``spec``'s device.
    """
    single = spec.dim() == 3
    if single:
        spec = spec[None]
    e, b, f_len, t_len = spec.shape
    if draws is None:
        draws = draw_views_params(gen, params, e, b, f_len, t_len, spec.device)
    elif single:
        draws = tuple(d[None] for d in draws)
    ys, tmask, fmask = draws
    fn = views_reference if spec.device.type == "cpu" else views_cuda
    out = fn(spec, ys, tmask.bool(), fmask.bool(), float(params.mask_value))
    return out[0] if single else out


@dataclasses.dataclass(frozen=True)
class SpecAugment:
    """Configured SpecAugment callable (JAX ``SpecAugment``,
    ops/specaugment.py:244): ``spec_augment_views`` with these parameters,
    drawing from a ``torch.Generator`` where the JAX one takes a key."""

    params: SpecAugParams

    def __call__(
        self, spec: torch.Tensor, gen: Optional[torch.Generator], draws: Optional[Draws] = None
    ) -> torch.Tensor:
        return spec_augment_views(spec, gen, self.params, draws)

    @property
    def num_views(self) -> int:
        return NUM_VIEWS
