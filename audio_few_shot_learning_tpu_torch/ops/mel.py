"""Log-mel spectrogram extraction on the device.

Counterpart of the JAX package's ``ops/mel.py``, with its two flavours:

* online: HTK mel scale, no norm, reflect centre padding,
  ``10*log10(mel + f32 eps)`` (the reference's torchaudio path for
  wav-input episodes);
* offline: Slaney scale, Slaney norm, constant centre padding,
  ``20/power*log10(mel + 2**-52)`` (the reference's librosa path that
  builds the feature stores; the raw-audio predict path).

Structure: frame (``Tensor.unfold``) -> window -> ``torch.fft.rfft`` ->
``re**2 + im**2`` in plain PyTorch (the JAX package left the FFT to XLA), then
the filterbank projection and the log in one kernel: the plain version
``mel_log_reference`` for CPU tensors, K3 (``csrc/mel.cu``) for CUDA tensors.

K3 uses the filterbank's shape: every triangular filter's nonzero bins form
one contiguous range, 1-24 bins wide for the 128-band filterbanks (about
1 000 nonzeros of 65 664), so the kernel sums each band over its own range
(``BandTable``) instead of the dense product. It is bound by bytes: one
persistent block per SM walks 32-row tiles that TMA bulk copies bring into
a ring of shared-memory buffers (``mel_plan`` sizes the launch).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from audio_few_shot_learning_tpu_torch.config import (
    HOP_LENGTH,
    MEL_POWER,
    N_FFT,
    N_MELS,
    SAMPLE_RATE,
)
from audio_few_shot_learning_tpu_torch.ops import cuda_build

_F64EPS = float(np.finfo(np.float64).eps)  # 2**-52, added in float32 like the JAX package
_F32EPS = float(np.finfo(np.float32).eps)
TILE_ROWS = 32  # spectrogram rows per tile of K3, one per lane (csrc/mel.cu kRows)
MAX_STAGES = 3  # tile buffers in K3's ring (csrc/mel.cu kMaxStages)
HEADER_BYTES = 128  # K3's mbarriers, ahead of the ring (csrc/mel.cu kHeaderBytes)
SMEM_LIMIT = 227 * 1024  # shared memory one block may use on Hopper


def _hz_to_mel(f: np.ndarray, scale: str) -> np.ndarray:
    f = np.asarray(f, dtype=np.float64)
    if scale == "htk":
        return 2595.0 * np.log10(1.0 + f / 700.0)
    if scale == "slaney":
        f_sp = 200.0 / 3.0
        min_log_hz = 1000.0
        logstep = np.log(6.4) / 27.0
        mel = f / f_sp
        log_region = f >= min_log_hz
        mel = np.where(
            log_region,
            min_log_hz / f_sp + np.log(np.maximum(f, min_log_hz) / min_log_hz) / logstep,
            mel,
        )
        return mel
    raise ValueError(f"unknown mel scale {scale!r}")


def _mel_to_hz(m: np.ndarray, scale: str) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    if scale == "htk":
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    if scale == "slaney":
        f_sp = 200.0 / 3.0
        min_log_hz = 1000.0
        min_log_mel = min_log_hz / f_sp
        logstep = np.log(6.4) / 27.0
        hz = m * f_sp
        log_region = m >= min_log_mel
        hz = np.where(log_region, min_log_hz * np.exp(logstep * (m - min_log_mel)), hz)
        return hz
    raise ValueError(f"unknown mel scale {scale!r}")


def mel_filterbank(
    sr: int = SAMPLE_RATE,
    n_fft: int = N_FFT,
    n_mels: int = N_MELS,
    f_min: float = 0.0,
    f_max: Optional[float] = None,
    scale: str = "htk",
    norm: Optional[str] = None,
) -> np.ndarray:
    """Triangular mel filterbank, shape [n_fft//2 + 1, n_mels].

    ``scale='htk', norm=None`` matches torchaudio defaults (the reference's
    online extractor); ``scale='slaney', norm='slaney'`` matches librosa
    defaults (the reference's offline extractor).
    """
    f_max = float(sr) / 2 if f_max is None else f_max
    n_freqs = n_fft // 2 + 1
    all_freqs = np.linspace(0, sr // 2, n_freqs)

    m_min = _hz_to_mel(np.array(f_min), scale)
    m_max = _hz_to_mel(np.array(f_max), scale)
    m_pts = np.linspace(m_min, m_max, n_mels + 2)
    f_pts = _mel_to_hz(m_pts, scale)

    # Triangular filters: rising slope from f_pts[i] to f_pts[i+1], falling to f_pts[i+2]
    f_diff = f_pts[1:] - f_pts[:-1]  # [n_mels + 1]
    slopes = f_pts[None, :] - all_freqs[:, None]  # [n_freqs, n_mels + 2]
    down = -slopes[:, :-2] / f_diff[None, :-1]
    up = slopes[:, 2:] / f_diff[None, 1:]
    fb = np.maximum(0.0, np.minimum(down, up))  # [n_freqs, n_mels]

    if norm == "slaney":
        enorm = 2.0 / (f_pts[2 : n_mels + 2] - f_pts[:n_mels])
        fb = fb * enorm[None, :]
    elif norm is not None:
        raise ValueError(f"unknown filterbank norm {norm!r}")
    return fb.astype(np.float32)


def _hann(n: int) -> np.ndarray:
    # periodic Hann (torch.hann_window / scipy fftbins=True)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)).astype(np.float32)


def _center_pad(x: torch.Tensor, pad: int, pad_mode: str) -> torch.Tensor:
    """``[..., L] -> [..., L + 2*pad]``, as ``jnp.pad``/``np.pad`` pad.

    ``F.pad(mode="reflect")`` refuses ``pad >= L``, where numpy reflects
    again and again; reflect is done here as a gather from the periodic
    extension (period ``2*(L-1)``), which is numpy's result for every L >= 1.
    """
    if pad_mode == "constant":
        return F.pad(x, (pad, pad))
    if pad_mode != "reflect":
        raise ValueError(f"unknown pad mode {pad_mode!r}")
    length = x.shape[-1]
    if length == 0:
        raise ValueError("cannot reflect-pad an empty waveform")
    idx = torch.arange(-pad, length + pad, device=x.device)
    if length == 1:
        idx = torch.zeros_like(idx)
    else:
        period = 2 * (length - 1)
        idx = idx.remainder(period)
        idx = torch.where(idx > length - 1, period - idx, idx)
    return x[..., idx]


def power_spectrogram(
    wav: torch.Tensor,
    n_fft: int = N_FFT,
    hop_length: int = HOP_LENGTH,
    power: float = MEL_POWER,
    pad_mode: str = "reflect",
) -> torch.Tensor:
    """``[..., L]`` -> ``[..., frames, n_fft//2 + 1]`` float32, contiguous,
    frames = 1 + L // hop (centre padding by n_fft//2)."""
    x = _center_pad(wav.to(torch.float32), n_fft // 2, pad_mode)
    frames = x.unfold(-1, n_fft, hop_length)  # [..., frames, n_fft], a strided view
    window = torch.from_numpy(_hann(n_fft)).to(x.device)
    spec = torch.fft.rfft(frames * window, dim=-1)
    mag2 = torch.view_as_real(spec).square().sum(dim=-1)
    if power == 2.0:
        return mag2
    return mag2 ** (power / 2.0)


# ----------------------------------------------------------------------------
# Filterbank projection + log (K3)
# ----------------------------------------------------------------------------


def mel_log_reference(pspec: torch.Tensor, fb: torch.Tensor, log_mult: float, eps: float) -> torch.Tensor:
    """Plain PyTorch version of K3 (= ``_mel_log_xla``): pspec ``[..., K]``
    float32, fb ``[K, N]`` -> ``log_mult * log10(pspec @ fb + eps)`` ``[..., N]``.
    ``eps`` is a Python float, so it is added in float32."""
    return log_mult * torch.log10(pspec @ fb + eps)


@dataclasses.dataclass(frozen=True)
class BandTable:
    """A filterbank ``[K, N]`` as per-band contiguous ranges: band n's
    nonzero weights ``fb[lo[n]:lo[n] + length[n], n]`` are stored at
    ``weights[offset[n]:offset[n] + length[n]]``. All on one device."""

    weights: torch.Tensor  # [P] float32
    lo: torch.Tensor  # [N] int32
    length: torch.Tensor  # [N] int32
    offset: torch.Tensor  # [N] int32
    n_bins: int
    n_mels: int

    def to(self, device) -> "BandTable":
        return dataclasses.replace(
            self, **{f: getattr(self, f).to(device) for f in ("weights", "lo", "length", "offset")}
        )


def band_ranges(fb: np.ndarray):
    """``[lo, hi)`` of each band's nonzero bins (``lo = hi = 0`` for an all-zero band)."""
    fb = np.asarray(fb)
    nz = fb != 0
    any_nz = nz.any(axis=0)
    lo = np.where(any_nz, nz.argmax(axis=0), 0)
    hi = np.where(any_nz, fb.shape[0] - nz[::-1].argmax(axis=0), 0)
    return lo.astype(np.int64), hi.astype(np.int64)


def band_table(fb, lo=None, hi=None) -> BandTable:
    """Pack filterbank ``fb [K, N]`` (numpy or a tensor) by its band ranges
    (default: ``band_ranges(fb)``), on the CPU. Raises if any nonzero weight
    lies outside its band's ``[lo, hi)``: the kernel would not read it."""
    fb_np = fb.detach().cpu().numpy() if isinstance(fb, torch.Tensor) else np.asarray(fb)
    fb_np = np.ascontiguousarray(fb_np, dtype=np.float32)
    if lo is None or hi is None:
        lo, hi = band_ranges(fb_np)
    lo, hi = np.asarray(lo, np.int64), np.asarray(hi, np.int64)
    k, n = fb_np.shape
    if lo.shape != (n,) or hi.shape != (n,) or (lo < 0).any() or (hi > k).any() or (hi < lo).any():
        raise ValueError(f"band ranges do not fit a [{k}, {n}] filterbank")
    rows = np.arange(k)[:, None]
    outside = (rows < lo[None, :]) | (rows >= hi[None, :])
    if (fb_np[outside] != 0).any():
        bands = sorted(set(np.nonzero(outside & (fb_np != 0))[1].tolist()))
        raise ValueError(f"filterbank has nonzero weights outside the band ranges of bands {bands[:8]}")
    length = hi - lo
    offset = np.concatenate([[0], np.cumsum(length)[:-1]])
    weights = np.concatenate([fb_np[lo[j] : hi[j], j] for j in range(n)] + [np.zeros(0, np.float32)])
    as_i32 = lambda a: torch.from_numpy(a.astype(np.int32))  # noqa: E731
    return BandTable(
        weights=torch.from_numpy(weights.astype(np.float32)),
        lo=as_i32(lo), length=as_i32(length), offset=as_i32(offset), n_bins=k, n_mels=n,
    )


def mel_smem_bytes(k: int, n_mels: int, n_weights: int, stages: int, table_in_smem: bool) -> int:
    """Shared memory of one K3 block (``csrc/mel.cu`` mel_smem_bytes): the
    mbarriers, ``stages`` tiles of 32 x K f32 and, when staged, the band
    table (weights padded to 16 bytes, then lo, length, offset)."""
    n = HEADER_BYTES + stages * TILE_ROWS * k * 4
    if table_in_smem:
        n += 4 * (cuda_build.round_up(n_weights, 4) + 3 * n_mels)
    return n


@dataclasses.dataclass(frozen=True)
class MelPlan:
    """K3's launch: ``grid`` persistent blocks, each with a ring of
    ``stages`` tile buffers that TMA bulk copies of ``tile_bytes`` fill.
    The first ``bulk_tiles`` tiles (every full tile when the base is 16-byte
    aligned, else none) go through the ring; the rest, a ragged last tile or
    all of them, are read by plain loads."""

    grid: int
    stages: int
    table_in_smem: bool
    smem_bytes: int
    tile_bytes: int
    bulk_tiles: int


def mel_plan(m: int, k: int, n_mels: int, n_weights: int, sm_count: int, aligned: bool = True) -> MelPlan:
    """The most stages (up to ``MAX_STAGES``) that fit ``SMEM_LIMIT``, with
    the band table in shared memory when it fits beside at least two; one
    block per SM (the ring takes most of an SM's shared memory)."""
    for table, least in ((True, 2), (False, 1)):
        for stages in range(MAX_STAGES, least - 1, -1):
            smem = mel_smem_bytes(k, n_mels, n_weights, stages, table)
            if smem <= SMEM_LIMIT:
                return MelPlan(
                    grid=max(1, min(cuda_build.cdiv(m, TILE_ROWS), sm_count)), stages=stages,
                    table_in_smem=table, smem_bytes=smem, tile_bytes=4 * TILE_ROWS * k,
                    bulk_tiles=m // TILE_ROWS if aligned else 0,
                )
    need = mel_smem_bytes(k, n_mels, n_weights, 1, False)
    raise ValueError(f"{k} bins need {need} B of shared memory per block; K3 takes at most {SMEM_LIMIT} B")


def mel_log_cuda(
    pspec: torch.Tensor,
    fb: torch.Tensor,
    log_mult: float,
    eps: float,
    bands: Optional[BandTable] = None,
) -> torch.Tensor:
    """Launch K3 on a CUDA tensor: pspec ``[..., T, K]`` float32, contiguous
    -> ``[..., N, T]`` float32, which is ``mel_log_reference(pspec, fb, ...)``
    with its last two axes swapped. ``bands`` (from ``band_table(fb)``, on the
    card) saves packing ``fb`` on every call, which reads it back to the host.
    Counts the launch in ``mel_log_cuda.launches``."""
    if not pspec.is_cuda:
        raise ValueError("mel_log_cuda needs a CUDA tensor")
    if pspec.dtype != torch.float32:
        raise TypeError(f"the mel kernel takes a float32 power spectrogram, got {pspec.dtype}")
    if not pspec.is_contiguous():
        raise ValueError("the mel kernel takes a contiguous power spectrogram")
    if pspec.dim() < 2:
        raise ValueError(f"power spectrogram must be [..., T, K], got {tuple(pspec.shape)}")
    if bands is None:
        bands = band_table(fb).to(pspec.device)
    *lead, t_len, k = pspec.shape
    if k != bands.n_bins or tuple(fb.shape) != (bands.n_bins, bands.n_mels):
        raise ValueError(
            f"power spectrogram has {k} bins; filterbank {tuple(fb.shape)}, band table "
            f"[{bands.n_bins}, {bands.n_mels}]"
        )
    if any(t.device != pspec.device for t in (bands.weights, bands.lo, bands.length, bands.offset)):
        raise ValueError("the band table must be on the power spectrogram's device")
    m = pspec.numel() // k
    if m >= 2**31:
        raise ValueError(f"{m} spectrogram rows exceed the kernel's int32 row count")
    n_weights = bands.weights.numel()
    sm_count = torch.cuda.get_device_properties(pspec.device).multi_processor_count
    plan = mel_plan(m, k, bands.n_mels, n_weights, sm_count, pspec.data_ptr() % 16 == 0)
    out = torch.empty((*lead, bands.n_mels, t_len), device=pspec.device, dtype=torch.float32)
    if m == 0:
        return out
    fn = cuda_build.function(
        "mel", "afsl_mel_log",
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_float] * 2 + [ctypes.c_int] * 5
        + [ctypes.c_void_p],
    )
    status = fn(
        cuda_build.ptr(pspec), cuda_build.ptr(bands.weights), cuda_build.ptr(bands.lo),
        cuda_build.ptr(bands.length), cuda_build.ptr(bands.offset), cuda_build.ptr(out),
        m, k, bands.n_mels, t_len, float(log_mult), float(eps),
        n_weights, plan.stages, int(plan.table_in_smem), plan.grid, plan.bulk_tiles,
        cuda_build.stream_handle(pspec.device),
    )
    cuda_build.check_launch(status, "mel kernel")
    mel_log_cuda.launches += 1
    return out


mel_log_cuda.launches = 0


def mel_log(
    pspec: torch.Tensor,
    fb: torch.Tensor,
    log_mult: float,
    eps: float,
    bands: Optional[BandTable] = None,
) -> torch.Tensor:
    """``[..., T, K] -> [..., N, T]`` log-mel: the plain version on the CPU,
    K3 on the card."""
    if pspec.device.type == "cpu":
        return mel_log_reference(pspec, fb, log_mult, eps).transpose(-1, -2)
    return mel_log_cuda(pspec, fb, log_mult, eps, bands)


class MelSpec:
    """Configured log-mel extractor (``flavor`` "online" or "offline", as in
    the module docstring). The filterbank and its band table are put on a
    device once, at the first call there."""

    def __init__(
        self,
        flavor: str = "online",
        sr: int = SAMPLE_RATE,
        n_fft: int = N_FFT,
        hop_length: int = HOP_LENGTH,
        n_mels: int = N_MELS,
        power: float = MEL_POWER,
    ):
        if flavor not in ("online", "offline"):
            raise ValueError(f"unknown flavor {flavor!r}")
        self.flavor, self.sr, self.n_fft = flavor, sr, n_fft
        self.hop_length, self.n_mels, self.power = hop_length, n_mels, power
        if flavor == "online":
            self.fb = mel_filterbank(sr, n_fft, n_mels, scale="htk", norm=None)
            self.pad_mode, self.eps, self.log_mult = "reflect", _F32EPS, 10.0
        else:
            self.fb = mel_filterbank(sr, n_fft, n_mels, scale="slaney", norm="slaney")
            self.pad_mode, self.eps, self.log_mult = "constant", _F64EPS, 20.0 / power
        self._on_device: Dict[torch.device, tuple] = {}

    def _filterbank(self, device: torch.device):
        cached = self._on_device.get(device)
        if cached is None:
            fb = torch.from_numpy(self.fb).to(device)
            bands = band_table(self.fb).to(device) if device.type == "cuda" else None
            cached = self._on_device[device] = (fb, bands)
        return cached

    def __call__(self, wav: torch.Tensor) -> torch.Tensor:
        """``[..., L]`` waveform -> ``[..., n_mels, frames]`` log-mel spectrogram."""
        pspec = power_spectrogram(wav, self.n_fft, self.hop_length, self.power, self.pad_mode)
        fb, bands = self._filterbank(pspec.device)
        return mel_log(pspec, fb, self.log_mult, self.eps, bands)


def log_mel_spectrogram(wav: torch.Tensor, flavor: str = "online", **kw) -> torch.Tensor:
    """``[..., L] -> [..., n_mels, frames]``: ``MelSpec(flavor, **kw)(wav)``
    (JAX ``log_mel_spectrogram``, ops/mel.py:251)."""
    return MelSpec(flavor=flavor, **kw)(wav)
