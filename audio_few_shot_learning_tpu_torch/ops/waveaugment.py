"""Waveform augmentation chain on the device (WaveAugment).

Counterpart of the JAX package's ``ops/waveaugment.py``: the reference's
probabilistic chain LowPass -> PitchShift -> Shift -> TimeInversion -> Gain
-> AddColoredNoise -> HighPass -> BandStop -> SpliceOut, then TimeStretch
and TimeMasking, each applied per row with its own probability, making
1 original + ``aug_num`` augmented copies. Cut-offs and SNR bounds adapt to
the dataset's spectral statistics (``FEATURE_STATS``).

Randomness is data here, as ``Draws`` is for SpecAugment: every transform
takes its draws (uniforms, per-row Bernoulli masks, the noise spectrum's
normals, splice-out's integer starts and widths) as a dict of tensors with
a leading row axis, and a ``draw_*`` function makes them from an explicit
``torch.Generator`` on the tensor's device, in the shapes and bounds of the
JAX draws. A chain's draws are a dict keyed by transform name
(``WaveAugment.draw``), so tests can hand this package the draws the JAX
package takes from its key.

The same functions in GPU idiom rather than the TPU formulation (no Pallas
kernel exists for any of them; FFTs go to cuFFT through ``torch.fft``):

* filters are rFFT-domain raised-cosine masks; noise, high-pass and
  band-stop share one rfft/irfft pair when two or more of them are on, with
  the coloured noise drawn directly in the spectrum (Parseval for its RMS);
* ``shift`` is a per-row gather at ``(i - offs) % L`` (the JAX package
  slices a doubled row inside a row scan);
* ``_resample_to_length`` is a two-tap gather per output sample (the JAX
  package fetches windows with one-hot matmuls), with the positions computed
  in the JAX package's blockwise float32 arithmetic so both agree;
* ``splice_out`` merges the intervals with a stable sort and a running
  ``cummax``, counts each sample's region over ``[B, N, L]`` and reads the
  zero-extended row with one gather (no row scan);
* ``pitch_shift_pv`` runs the phase vocoder over all rows at once, with the
  overlap-add as the sum of ``n_fft / hop`` shifted reshapes, added in frame
  order (the JAX package's scatter-add order) and deterministic on the card,
  where ``index_add_`` would sum with atomics in a varying order.

A transform whose probability is 0 is skipped, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from audio_few_shot_learning_tpu_torch.config import SAMPLE_RATE, WaveAugParams
from audio_few_shot_learning_tpu_torch.utils.profiling import spanned

# per-dataset spectral statistics (reference utils/augmentations.py:186-207)
FEATURE_STATS: Dict[str, Dict[str, float]] = {
    "FSD2018": {"avg_centroid": 1944, "avg_bandwidth": 1605, "avg_flatness": 0.056},
    "nsynth": {"avg_centroid": 1294, "avg_bandwidth": 961, "avg_flatness": 0.224},
    "ESC-50-master": {"avg_centroid": 1191, "avg_bandwidth": 1669, "avg_flatness": 0.144},
    "BirdClef": {"avg_centroid": 3038, "avg_bandwidth": 1910, "avg_flatness": 0.127},
}
_DEFAULT_STATS = {"avg_centroid": 2000, "avg_bandwidth": 1500, "avg_flatness": 0.1}

Draw = Dict[str, torch.Tensor]  # one transform's draws, leading row axis
ChainDraws = Dict[str, Draw]  # a chain's draws by transform name

# ---------------------------------------------------------------------------
# shared pieces
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _freqs_np(n: int, sr: int) -> np.ndarray:
    # float64 then rounded once: the JAX package's float32 rfftfreq values
    # (torch.fft.rfftfreq differs from them by up to 5e-4 Hz at n = 80 000)
    return np.fft.rfftfreq(n, 1.0 / sr).astype(np.float32)


def _freqs(n: int, sr: int, device) -> torch.Tensor:
    return torch.from_numpy(_freqs_np(n, sr)).to(device)


def _soft_edge(f: torch.Tensor, cutoff: torch.Tensor, width_hz: float = 50.0) -> torch.Tensor:
    """0 -> 1 raised-cosine transition centred at ``cutoff``."""
    t = ((f - cutoff) / width_hz + 0.5).clamp(0.0, 1.0)
    return 0.5 - 0.5 * torch.cos(math.pi * t)


def _fft_filter(x: torch.Tensor, gain_mask: torch.Tensor) -> torch.Tensor:
    """``[B, L]`` through per-row rFFT gain masks ``[B, L//2+1]``."""
    spec = torch.fft.rfft(x, dim=-1)
    return torch.fft.irfft(spec * gain_mask, n=x.shape[-1], dim=-1).to(x.dtype)


def _mix(applied: torch.Tensor, x_aug: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.where(applied[:, None], x_aug, x)


def _uniform(gen, shape, lo: float, hi: float, device) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device)


def _applied(gen, b: int, p: float, device) -> torch.Tensor:
    """Per-row Bernoulli(p) mask ``[B]`` (the JAX ``uniform < p``)."""
    return torch.rand((b,), generator=gen, device=device) < p


# ---------------------------------------------------------------------------
# filters, gain, inversion, shift, noise
# ---------------------------------------------------------------------------


def draw_lowpass(gen, b: int, min_cut: float, max_cut: float, p: float, device) -> Draw:
    return {"cut": _uniform(gen, (b, 1), min_cut, max_cut, device), "applied": _applied(gen, b, p, device)}


draw_highpass = draw_lowpass


def lowpass(x: torch.Tensor, d: Draw, sr: int = SAMPLE_RATE) -> torch.Tensor:
    mask = 1.0 - _soft_edge(_freqs(x.shape[1], sr, x.device)[None], d["cut"])
    return _mix(d["applied"], _fft_filter(x, mask), x)


def highpass(x: torch.Tensor, d: Draw, sr: int = SAMPLE_RATE) -> torch.Tensor:
    mask = _soft_edge(_freqs(x.shape[1], sr, x.device)[None], d["cut"])
    return _mix(d["applied"], _fft_filter(x, mask), x)


def draw_bandstop(
    gen, b: int, min_center: float, max_center: float, min_bw_frac: float, max_bw_frac: float,
    p: float, device,
) -> Draw:
    return {
        "center": _uniform(gen, (b, 1), min_center, max_center, device),
        "bw_frac": _uniform(gen, (b, 1), min_bw_frac, max_bw_frac, device),
        "applied": _applied(gen, b, p, device),
    }


def _stop_band(f: torch.Tensor, d: Draw) -> torch.Tensor:
    center = d["center"]
    bw = center * d["bw_frac"]
    return _soft_edge(f, center - bw / 2) * (1.0 - _soft_edge(f, center + bw / 2))


def bandstop(x: torch.Tensor, d: Draw, sr: int = SAMPLE_RATE) -> torch.Tensor:
    stop = _stop_band(_freqs(x.shape[1], sr, x.device)[None], d)
    return _mix(d["applied"], _fft_filter(x, 1.0 - stop), x)


def highpass_bandstop(x: torch.Tensor, d_hp: Draw, d_bs: Draw, sr: int = SAMPLE_RATE) -> torch.Tensor:
    """Fused HighPass -> BandStop: the per-row masks multiply, so both
    filters share one rfft/irfft pair (JAX ``highpass_bandstop``)."""
    f = _freqs(x.shape[1], sr, x.device)[None]
    hp_mask = torch.where(d_hp["applied"][:, None], _soft_edge(f, d_hp["cut"]), 1.0)
    mask = hp_mask * torch.where(d_bs["applied"][:, None], 1.0 - _stop_band(f, d_bs), 1.0)
    return _mix(d_hp["applied"] | d_bs["applied"], _fft_filter(x, mask), x)


def draw_gain(gen, b: int, min_db: float, max_db: float, p: float, device) -> Draw:
    return {"db": _uniform(gen, (b, 1), min_db, max_db, device), "applied": _applied(gen, b, p, device)}


def gain(x: torch.Tensor, d: Draw) -> torch.Tensor:
    return _mix(d["applied"], x * 10.0 ** (d["db"] / 20.0), x)


def draw_time_inversion(gen, b: int, p: float, device) -> Draw:
    return {"applied": _applied(gen, b, p, device)}


def time_inversion(x: torch.Tensor, d: Draw) -> torch.Tensor:
    return _mix(d["applied"], x.flip(-1), x)


def draw_shift(gen, b: int, min_shift: float, max_shift: float, p: float, device) -> Draw:
    return {"frac": _uniform(gen, (b,), min_shift, max_shift, device), "applied": _applied(gen, b, p, device)}


def shift(x: torch.Tensor, d: Draw) -> torch.Tensor:
    """Fractional circular shift (rollover): ``out[i] = x[(i - offs) % L]``
    with ``offs = int32(frac * L) % L`` (truncation toward zero, then a
    floor modulo, as ``astype(int32)`` and ``%`` do in the JAX package)."""
    b, l = x.shape
    offs = (d["frac"] * l).to(torch.int32).long() % l
    idx = (torch.arange(l, device=x.device)[None] - offs[:, None]) % l
    return _mix(d["applied"], x.gather(1, idx), x)


def draw_colored_noise(
    gen, b: int, l: int, min_snr_db: float, max_snr_db: float, min_f_decay: float,
    max_f_decay: float, p: float, device,
) -> Draw:
    """Draws of the time-domain ``add_colored_noise``: white noise ``[B, L]``."""
    return {
        "snr": _uniform(gen, (b, 1), min_snr_db, max_snr_db, device),
        "decay": _uniform(gen, (b, 1), min_f_decay, max_f_decay, device),
        "white": torch.randn((b, l), generator=gen, device=device),
        "applied": _applied(gen, b, p, device),
    }


def _noise_shape(f: torch.Tensor, decay: torch.Tensor) -> torch.Tensor:
    return torch.where(f > 0, f.clamp_min(1.0) ** (decay / 2.0), 0.0)


def _rms(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.mean(x * x, dim=-1, keepdim=True) + 1e-12)


def add_colored_noise(x: torch.Tensor, d: Draw, sr: int = SAMPLE_RATE) -> torch.Tensor:
    """White noise shaped by ``f^(-decay/2)`` in the spectrum, scaled to the
    drawn SNR against the row's RMS."""
    f = _freqs(x.shape[1], sr, x.device)[None]
    noise = _fft_filter(d["white"], _noise_shape(f, d["decay"]))
    target = _rms(x) / (10.0 ** (d["snr"] / 20.0))
    return _mix(d["applied"], x + noise * (target / _rms(noise)), x)


def draw_noise_spectrum(
    gen, b: int, l: int, min_snr_db: float, max_snr_db: float, min_f_decay: float,
    max_f_decay: float, p: float, device,
) -> Draw:
    """Draws of the fused group's noise: the unit normals of its spectrum,
    ``[B, L//2+1, 2]`` (real, imaginary)."""
    return {
        "snr": _uniform(gen, (b, 1), min_snr_db, max_snr_db, device),
        "decay": _uniform(gen, (b, 1), min_f_decay, max_f_decay, device),
        "w": torch.randn((b, l // 2 + 1, 2), generator=gen, device=device),
        "applied": _applied(gen, b, p, device),
    }


def noise_highpass_bandstop(
    x: torch.Tensor,
    d_noise: Optional[Draw],
    d_hp: Optional[Draw],
    d_bs: Optional[Draw],
    sr: int = SAMPLE_RATE,
    d_lp: Optional[Draw] = None,
) -> torch.Tensor:
    """Fused AddColoredNoise -> HighPass -> BandStop (and LowPass with
    ``fuse_lowpass``) on one rfft/irfft pair (JAX ``noise_highpass_bandstop``,
    ``:176-256``). A member whose draws are None has probability 0 and is
    skipped. The rDFT of unit white noise has i.i.d. N(0, L/2) real and
    imaginary parts on interior bins and real N(0, L) parts at DC (and at
    Nyquist for even L), so the noise is drawn in the spectrum; its RMS for
    the SNR comes from Parseval: ``sum n_t^2 = (|N_0|^2 + 2 sum_interior
    |N_k|^2 + |N_Nyq|^2) / L``."""
    b, l = x.shape
    f = _freqs(l, sr, x.device)[None]
    n_freqs = l // 2 + 1
    spec = torch.fft.rfft(x, dim=-1)
    any_applied = torch.zeros((b,), dtype=torch.bool, device=x.device)
    if d_noise is not None:
        w = d_noise["w"]
        kidx = torch.arange(n_freqs, device=x.device)
        edge = (kidx == 0) | (kidx == n_freqs - 1) if l % 2 == 0 else kidx == 0
        real = w[..., 0] * torch.where(edge, math.sqrt(float(l)), math.sqrt(l / 2.0))
        imag = w[..., 1] * torch.where(edge, 0.0, math.sqrt(l / 2.0))
        shape = _noise_shape(f, d_noise["decay"])
        nspec = torch.complex(real, imag) * shape
        w2 = (real * real + imag * imag) * shape * shape
        mult = torch.where(edge, 1.0, 2.0)[None]
        noise_rms = torch.sqrt(torch.sum(w2 * mult, dim=-1, keepdim=True) / float(l) ** 2 + 1e-12)
        target = _rms(x) / (10.0 ** (d_noise["snr"] / 20.0))
        applied = d_noise["applied"]
        spec = spec + torch.where(applied[:, None], target / noise_rms, 0.0) * nspec
        any_applied = any_applied | applied
    mask = torch.ones((1, 1), device=x.device)
    if d_lp is not None:  # the opt-in fuse_lowpass reorder (PARITY.md)
        mask = mask * torch.where(d_lp["applied"][:, None], 1.0 - _soft_edge(f, d_lp["cut"]), 1.0)
        any_applied = any_applied | d_lp["applied"]
    if d_hp is not None:
        mask = mask * torch.where(d_hp["applied"][:, None], _soft_edge(f, d_hp["cut"]), 1.0)
        any_applied = any_applied | d_hp["applied"]
    if d_bs is not None:
        mask = mask * torch.where(d_bs["applied"][:, None], 1.0 - _stop_band(f, d_bs), 1.0)
        any_applied = any_applied | d_bs["applied"]
    out = torch.fft.irfft(spec * mask, n=l, dim=-1).to(x.dtype)
    return _mix(any_applied, out, x)


# ---------------------------------------------------------------------------
# resampling: pitch shift, time stretch, phase vocoder
# ---------------------------------------------------------------------------

_RS_BLK = 32  # the JAX package's resample block: its positions are blockwise


def _resample_geometry(l: int, out_len: int, max_rate: float) -> Tuple[int, int, int]:
    """(window, rows, shifts) of the JAX package's blocked resample
    (``:284-293``): they size its zero padding and its index clips."""
    blk = _RS_BLK
    n_blocks = -(-out_len // blk)
    win = blk * (1 + int(np.ceil((blk * max_rate + 2.0) / blk)))
    n_shift = win // blk
    max_base = int(np.floor((n_blocks - 1) * blk * max_rate)) + win
    n_rows = max(-(-max_base // blk) + 1, -(-l // blk))
    return win, n_rows, n_shift


def _resample_to_length(
    x: torch.Tensor, rate: torch.Tensor, out_len: int, max_rate: float = 1.5
) -> torch.Tensor:
    """Per-row linear-interpolation resample by ``rate`` ``[B]`` to
    ``out_len`` samples, zero where ``i * rate`` passes the last input sample.

    A two-tap gather per output sample ``i = 32 b + j``. The source position
    is the JAX package's blocked float32 arithmetic (``:305-310``):
    ``gstart = b * (32 r)``, ``m = floor(gstart) // 32``,
    ``pos = (gstart - 32 m) + j r``, taps at ``32 m + floor(pos)`` and ``+1``.
    It drifts from exact ``i * r`` by ~1e-2 at i ~ 1e5; computing it the same
    way keeps the two packages within float32 rounding of each other. The
    JAX package's clips (``m`` to its window rows, ``floor(pos)`` to
    ``[0, win - 2]``) cannot bind for ``rate <= max_rate`` (``pos < 32 +
    31 max_rate <= win - 2``) and are kept all the same; reads past the row
    see its zero padding."""
    b, l = x.shape
    blk = _RS_BLK
    win, n_rows, n_shift = _resample_geometry(l, out_len, max_rate)
    r = rate.to(torch.float32).clamp(1e-3, max_rate)[:, None]
    i = torch.arange(out_len, device=x.device)
    bi = (i // blk).to(torch.float32)
    j = (i % blk).to(torch.float32)
    gstart = bi * (blk * r)
    m = (torch.floor(gstart).to(torch.int32) // blk).clamp(0, n_rows - 1)
    pos = (gstart - (m * blk).to(torch.float32)) + j * r
    p0 = torch.floor(pos).to(torch.int32).clamp(0, win - 2)
    frac = pos - p0
    src = (m * blk + p0).long()
    xp = F.pad(x, (0, (n_rows + n_shift) * blk - l))
    out = (1.0 - frac) * xp.gather(1, src) + frac * xp.gather(1, src + 1)
    valid = i * r <= (l - 1)
    return torch.where(valid, out, 0.0).to(x.dtype)


def _semitone_bound(min_semitones: float, max_semitones: float) -> float:
    return 2.0 ** (max(abs(min_semitones), abs(max_semitones)) / 12.0)


def draw_pitch_shift(gen, b: int, min_semitones: float, max_semitones: float, p: float, device) -> Draw:
    """The rate ``2^(st/12)`` of a uniform semitone draw. The rate, not the
    semitones, is the draw: 1-ulp differences in ``2^x`` between libraries
    would move positions near i ~ 8e4 by ~1e-2 samples."""
    st = _uniform(gen, (b,), min_semitones, max_semitones, device)
    return {"rate": 2.0 ** (st / 12.0), "applied": _applied(gen, b, p, device)}


def pitch_shift(x: torch.Tensor, d: Draw, min_semitones: float, max_semitones: float) -> torch.Tensor:
    """Resample-based pitch shift, the duration restored by clipping or
    zero padding (the JAX package's default, a documented approximation)."""
    max_rate = _semitone_bound(min_semitones, max_semitones)
    return _mix(d["applied"], _resample_to_length(x, d["rate"], x.shape[1], max_rate), x)


@functools.lru_cache(maxsize=None)
def _pv_tables(l: int, f_upper: float, n_fft: int, hop: int):
    """Static shapes and tables of ``_pv_shift``: the periodic Hann window,
    frame counts, the stretched buffer's length and its window-sum
    normaliser (numpy, as the JAX package computes it at trace time)."""
    win_np = (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n_fft) / n_fft)).astype(np.float32)
    t_frames = 1 + (l - n_fft) // hop
    out_t = int(np.ceil((t_frames - 1) * f_upper)) + 1
    tail_pad = int(np.ceil(n_fft * f_upper)) + 1
    buf_len = (out_t - 1) * hop + n_fft + tail_pad
    pos = (hop * np.arange(out_t)[:, None] + np.arange(n_fft)[None, :]).ravel()
    wsum = np.zeros(buf_len, np.float32)
    np.add.at(wsum, pos, np.tile(win_np**2, out_t))
    return win_np, t_frames, out_t, buf_len, np.maximum(wsum, 1e-8)


def _pv_shift(
    x: torch.Tensor, f: torch.Tensor, f_upper: float, n_fft: int = 1024, hop: int = 256
) -> torch.Tensor:
    """Duration-preserving pitch shift of every row of ``x [B, L]`` by its
    factor ``f [B]`` (JAX ``_pv_shift_row``, ``:342-396``, batched over
    rows): a phase-vocoder time stretch by f (duration L*f, pitch kept),
    then a rate-f linear read back to L samples (pitch x f). ``f_upper``
    bounds f and sizes the stretched buffer. Needs ``L >= n_fft + hop``."""
    if n_fft % hop:
        raise ValueError(f"hop {hop} must divide n_fft {n_fft}")
    b, l = x.shape
    win_np, t_frames, out_t, buf_len, wsum = _pv_tables(l, float(f_upper), n_fft, hop)
    dev = x.device
    win = torch.from_numpy(win_np).to(dev)
    k_bins = n_fft // 2 + 1
    spec = torch.fft.rfft(x.unfold(-1, n_fft, hop) * win, dim=-1)  # [B, T, K]
    mag, ph = spec.abs(), spec.angle()
    del spec
    omega = torch.from_numpy(((2.0 * np.pi * hop / n_fft) * np.arange(k_bins)).astype(np.float32)).to(dev)

    t = torch.arange(out_t, dtype=torch.float32, device=dev) / f[:, None]  # analysis positions
    t0 = torch.floor(t).long().clamp(0, t_frames - 2)
    frac = (t - t0).clamp(0.0, 1.0)[..., None]
    i0 = t0[..., None].expand(b, out_t, k_bins)
    mag_i = (1.0 - frac) * mag.gather(1, i0) + frac * mag.gather(1, i0 + 1)
    ph0 = ph.gather(1, i0)
    dphi = ph.gather(1, i0 + 1) - ph0 - omega
    dphi = dphi - 2.0 * np.pi * torch.round(dphi / (2.0 * np.pi))  # principal value
    advance = dphi + omega  # true per-hop phase advance around t0
    acc = ph0[:, :1] + F.pad(torch.cumsum(advance[:, :-1], dim=1), (0, 0, 1, 0))
    y = torch.fft.irfft(torch.polar(mag_i, acc), n=n_fft, dim=-1) * win  # [B, out_t, n_fft]

    # overlap-add: hop divides n_fft, so chunk c of the buffer sums sub-chunk
    # s of frame c - s; earliest frame first, as the JAX scatter-add adds
    r = n_fft // hop
    yq = y.reshape(b, out_t, r, hop)
    buf = None
    for s in reversed(range(r)):
        term = F.pad(yq[:, :, s], (0, 0, s, r - 1 - s))
        buf = term if buf is None else buf + term
    buf = F.pad(buf.reshape(b, -1), (0, buf_len - (out_t + r - 1) * hop))
    buf = buf / torch.from_numpy(wsum).to(dev)

    rp = torch.arange(l, dtype=torch.float32, device=dev) * f[:, None]  # read back at rate f
    r0 = torch.floor(rp).long().clamp(0, buf_len - 2)
    fr = rp - r0
    return (1.0 - fr) * buf.gather(1, r0) + fr * buf.gather(1, r0 + 1)


def pitch_shift_pv(x: torch.Tensor, d: Draw, min_semitones: float, max_semitones: float) -> torch.Tensor:
    """Duration-preserving pitch shift (``pitchshift_mode: "pv"``), the same
    draws as ``pitch_shift``."""
    f_upper = _semitone_bound(min_semitones, max_semitones)
    return _mix(d["applied"], _pv_shift(x, d["rate"], f_upper).to(x.dtype), x)


def draw_time_stretch(gen, b: int, min_ratio: float, max_ratio: float, p: float, device) -> Draw:
    return {"ratio": _uniform(gen, (b,), min_ratio, max_ratio, device), "applied": _applied(gen, b, p, device)}


def time_stretch(x: torch.Tensor, d: Draw, min_ratio: float, max_ratio: float) -> torch.Tensor:
    """sox-stretch equivalent: resample by 1/ratio, length fixed."""
    max_rate = 1.0 / min(min_ratio, max_ratio)
    return _mix(d["applied"], _resample_to_length(x, 1.0 / d["ratio"], x.shape[1], max_rate), x)


# ---------------------------------------------------------------------------
# splice-out, time masking
# ---------------------------------------------------------------------------


def draw_splice_out(gen, b: int, l: int, num_intervals: int, max_width: int, p: float, device) -> Draw:
    shape = (b, num_intervals)
    return {
        "starts": torch.randint(0, max(l - max_width, 1), shape, generator=gen, device=device),
        "widths": torch.randint(1, max_width + 1, shape, generator=gen, device=device),
        "applied": _applied(gen, b, p, device),
    }


def splice_out(x: torch.Tensor, d: Draw, num_intervals: int, max_width: int) -> torch.Tensor:
    """Remove up to ``num_intervals`` intervals and compact, zero-padding the
    tail (JAX ``splice_out``, ``:423-483``). The intervals merge into sorted
    disjoint cuts (stable sort, running max of the ends); output sample i
    reads source ``i + C_k`` where ``C_k`` is the cut width before the k-th
    breakpoint ``b_k = s_k - C_{k-1}``, k counted over ``[B, N, L]``."""
    b, l = x.shape
    order = torch.argsort(d["starts"], dim=1, stable=True)
    starts = d["starts"].gather(1, order)
    ends = starts + d["widths"].gather(1, order)
    prev_max = F.pad(torch.cummax(ends, dim=1).values[:, :-1], (1, 0))
    cut_start = torch.maximum(starts, prev_max)
    cut_width = torch.maximum(ends, prev_max) - cut_start  # 0 = swallowed
    cum = torch.cumsum(cut_width, dim=1)
    bkpt = cut_start - F.pad(cum[:, :-1], (1, 0))  # nondecreasing output breakpoints
    idx = torch.arange(l, device=x.device)
    region = (idx[None, None, :] >= bkpt[:, :, None]).sum(dim=1)  # [B, L] in 0..N
    src = idx + F.pad(cum, (1, 0)).gather(1, region)
    out = F.pad(x, (0, num_intervals * max_width)).gather(1, src)
    return _mix(d["applied"], out, x)


def draw_time_masking(gen, b: int, l: int, num_masks: int, mask_fraction: float, p: float, device) -> Draw:
    mask_len = max(int(l * mask_fraction), 1)
    return {
        "starts": torch.randint(0, max(l - mask_len, 1), (b, num_masks), generator=gen, device=device),
        "applied": _applied(gen, b, p, device),
    }


def time_masking(x: torch.Tensor, d: Draw, num_masks: int, mask_fraction: float) -> torch.Tensor:
    """Zero ``num_masks`` windows of ``int(L * mask_fraction)`` samples."""
    l = x.shape[1]
    mask_len = max(int(l * mask_fraction), 1)
    idx = torch.arange(l, device=x.device)[None, None, :]
    s = d["starts"][:, :, None]
    masked = ((idx >= s) & (idx < s + mask_len)).any(dim=1)
    return _mix(d["applied"], x.masked_fill(masked, 0.0), x)


# ---------------------------------------------------------------------------
# the chain
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _Step:
    """One step of the chain: ``draw(gen, rows, length, device)`` returns
    its draws by transform name; ``apply(x, draws)`` reads them;
    ``row_bytes(length)`` is its largest working set per row."""

    draw: Callable[..., ChainDraws]
    apply: Callable[[torch.Tensor, ChainDraws], torch.Tensor]
    row_bytes: Callable[[int], int]


@dataclasses.dataclass(frozen=True)
class WaveAugment:
    """The configured chain in the reference's order
    (utils/augmentations.py:279-376,422-451; JAX ``WaveAugment``)."""

    params: WaveAugParams
    dataset_name: str = "ESC-50-master"
    sr: int = SAMPLE_RATE

    @property
    def num_views(self) -> int:
        return 1 + self.params.aug_num

    def _steps(self) -> List[_Step]:
        """The static chain (JAX ``apply_once``, ``:512-632``): a transform
        of probability 0 is left out; noise, high-pass and band-stop fuse
        when two or more are on, or with ``fuse_lowpass``. A fused low-pass
        is still drawn at its own place in the chain, so both orders take
        the same draws from one generator (the pair of arms of
        ``scripts/torch_port_ab_deviations.py``)."""
        p = self.params.raw
        stats = FEATURE_STATS.get(self.dataset_name, _DEFAULT_STATS)
        centroid = float(stats["avg_centroid"])
        bandwidth = float(stats["avg_bandwidth"])
        flatness = float(stats["avg_flatness"])
        max_snr = float(p.get("max_snr_in_db", 25.0))
        min_snr = float(p.get("min_snr_in_db", 10.0))
        adapted = max_snr * (1.0 - flatness)  # augmentations.py:222-231
        sr = self.sr

        def prob(name, default):
            return float(p.get(name, default))

        p_lp, p_noise = prob("lowpass_p", 0.5), prob("noise_p", 0.5)
        p_hp, p_bs = prob("highpass_p", 0.3), prob("bandstop_p", 0.5)
        fuse_lp = bool(p.get("fuse_lowpass", False)) and p_lp > 0 and (p_noise > 0 or p_hp > 0 or p_bs > 0)
        lp_cut = (centroid, centroid + bandwidth / 2)
        hp_cut = (centroid - bandwidth / 2, centroid)
        bs_args = (centroid - bandwidth / 2, centroid, p.get("bandstop_min_bandwidth_fraction", 0.5),
                   p.get("bandstop_max_bandwidth_fraction", 1.0))
        noise_args = (min_snr, adapted, p.get("noise_min_f_decay", -2), p.get("noise_max_f_decay", 2))
        fft_bytes = lambda l: 40 * l  # noqa: E731  spectrum, mask, product, irfft out (c64/f32)
        steps: List[_Step] = []

        if p_lp > 0:  # fused, the group applies it: drawn here all the same, so both orders draw alike
            steps.append(_Step(
                lambda g, b, l, dev: {"lowpass": draw_lowpass(g, b, *lp_cut, p_lp, dev)},
                (lambda x, d: x) if fuse_lp else (lambda x, d: lowpass(x, d["lowpass"], sr)),
                (lambda l: 0) if fuse_lp else fft_bytes))
        p_ps = prob("pitchshift_p", 0.5)
        if p_ps > 0:
            st = (p.get("pitchshift_min_transpose_semitones", -4), p.get("pitchshift_max_transpose_semitones", 4))
            if p.get("pitchshift_mode", "resample") == "pv":
                ps_fn, ps_bytes = pitch_shift_pv, functools.partial(_pv_row_bytes, f_upper=_semitone_bound(*st))
            else:
                ps_fn, ps_bytes = pitch_shift, _resample_row_bytes
            steps.append(_Step(
                lambda g, b, l, dev: {"pitchshift": draw_pitch_shift(g, b, *st, p_ps, dev)},
                lambda x, d: ps_fn(x, d["pitchshift"], *st), ps_bytes))
        p_sh = prob("shift_p", 0.5)
        if p_sh > 0:
            sh = (p.get("shift_min_shift", -0.5), p.get("shift_max_shift", 0.5))
            steps.append(_Step(
                lambda g, b, l, dev: {"shift": draw_shift(g, b, *sh, p_sh, dev)},
                lambda x, d: shift(x, d["shift"]), lambda l: 24 * l))
        p_ti = prob("timeinversion_p", 0.0)
        if p_ti > 0:
            steps.append(_Step(
                lambda g, b, l, dev: {"timeinversion": draw_time_inversion(g, b, p_ti, dev)},
                lambda x, d: time_inversion(x, d["timeinversion"]), lambda l: 8 * l))
        p_g = prob("gain_p", 0.5)
        if p_g > 0:
            gn = (p.get("min_gain_in_db", -6), p.get("max_gain_in_db", 6))
            steps.append(_Step(
                lambda g, b, l, dev: {"gain": draw_gain(g, b, *gn, p_g, dev)},
                lambda x, d: gain(x, d["gain"]), lambda l: 8 * l))
        if fuse_lp or (p_noise > 0) + (p_hp > 0) + (p_bs > 0) >= 2:

            def draw_group(g, b, l, dev):
                out = {}
                if p_noise > 0:
                    out["noise"] = draw_noise_spectrum(g, b, l, *noise_args, p_noise, dev)
                if p_hp > 0:
                    out["highpass"] = draw_highpass(g, b, *hp_cut, p_hp, dev)
                if p_bs > 0:
                    out["bandstop"] = draw_bandstop(g, b, *bs_args, p_bs, dev)
                return out

            steps.append(_Step(
                draw_group,
                lambda x, d: noise_highpass_bandstop(
                    x, d.get("noise"), d.get("highpass"), d.get("bandstop"), sr,
                    d_lp=d["lowpass"] if fuse_lp else None),
                lambda l: 64 * l))
        elif p_noise > 0:
            steps.append(_Step(
                lambda g, b, l, dev: {"noise": draw_colored_noise(g, b, l, *noise_args, p_noise, dev)},
                lambda x, d: add_colored_noise(x, d["noise"], sr), lambda l: 48 * l))
        elif p_hp > 0:
            steps.append(_Step(
                lambda g, b, l, dev: {"highpass": draw_highpass(g, b, *hp_cut, p_hp, dev)},
                lambda x, d: highpass(x, d["highpass"], sr), fft_bytes))
        elif p_bs > 0:
            steps.append(_Step(
                lambda g, b, l, dev: {"bandstop": draw_bandstop(g, b, *bs_args, p_bs, dev)},
                lambda x, d: bandstop(x, d["bandstop"], sr), fft_bytes))
        p_so = prob("spliceout_p", 0.5)
        if p_so > 0:
            so = (int(p.get("spliceout_num_time_intervals", 8)), int(p.get("spliceout_max_width", 400)))
            steps.append(_Step(
                lambda g, b, l, dev: {"spliceout": draw_splice_out(g, b, l, *so, p_so, dev)},
                lambda x, d: splice_out(x, d["spliceout"], *so),
                lambda l: (so[0] + 36) * l))
        p_ts = prob("timestretch_p", 0.0)
        if p_ts > 0:
            ts = (p.get("min_stretch_ratio", 0.9), p.get("max_stretch_ratio", 1.1))
            steps.append(_Step(
                lambda g, b, l, dev: {"timestretch": draw_time_stretch(g, b, *ts, p_ts, dev)},
                lambda x, d: time_stretch(x, d["timestretch"], *ts), _resample_row_bytes))
        p_tm = prob("timemasking_p", 0.5)
        if p_tm > 0:
            tm = (int(p.get("timemasking_masks", 5)), float(p.get("timemasking_mask_fraction", 0.01)))
            steps.append(_Step(
                lambda g, b, l, dev: {"timemasking": draw_time_masking(g, b, l, *tm, p_tm, dev)},
                lambda x, d: time_masking(x, d["timemasking"], *tm),
                lambda l: (3 * tm[0] + 12) * l))
        return steps

    @spanned("afsl.draws")
    def draw(self, gen: torch.Generator, shape: Sequence[int], length: int, device) -> ChainDraws:
        """Draws of every step for rows of leading ``shape`` (``[..., aug_num,
        B]`` for ``__call__``), each leaf ``[*shape, ...]``, from ``gen``."""
        shape = tuple(shape)
        rows = int(np.prod(shape))
        out: ChainDraws = {}
        for step in self._steps():
            out.update(step.draw(gen, rows, length, device))
        return {name: {k: v.reshape(*shape, *v.shape[1:]) for k, v in d.items()} for name, d in out.items()}

    def apply_once(self, x: torch.Tensor, draws: ChainDraws) -> torch.Tensor:
        """One augmented copy of ``x [R, L]`` with draws of leading ``[R]``."""
        for step in self._steps():
            x = step.apply(x, draws)
        return x

    def row_bytes(self, length: int) -> int:
        """The chain's device bytes per augmented row of ``length`` samples:
        what lives through the whole call (the tiled input, the chain's
        output and the concatenated views, float32, and the noise spectrum's
        draws) plus the largest step's temporaries, reckoned from their
        shapes (spectra, index and position tensors, splice-out's ``[N, L]``
        comparison, the phase vocoder's frames)."""
        steps = self._steps()
        return 20 * length + max((s.row_bytes(length) for s in steps), default=0)

    def __call__(
        self,
        x: torch.Tensor,
        gen: Optional[torch.Generator] = None,
        draws: Optional[ChainDraws] = None,
    ) -> torch.Tensor:
        """``[..., B, L] -> [..., B, 1 + aug_num, L]``, the original first
        (utils/augmentations.py:429-451). The ``aug_num`` copies fold into
        the rows copy-major, ``[..., aug_num, B]``, and go through one chain
        application: every draw is per row, so the copies stay independent.
        ``draws`` (leaves ``[..., aug_num, B, ...]``, as ``draw`` makes them)
        fixes the randomness; otherwise it comes from ``gen``."""
        *lead, b, l = x.shape
        n = self.params.aug_num
        shape = (*lead, n, b)
        if draws is None:
            draws = self.draw(gen, shape, l, x.device)
        k = len(shape)
        flat = {name: {key: v.reshape(-1, *v.shape[k:]) for key, v in d.items()} for name, d in draws.items()}
        tiled = x.unsqueeze(-3).expand(*shape, l).reshape(-1, l)
        aug = self.apply_once(tiled, flat).reshape(*shape, l)
        return torch.cat([x.unsqueeze(-2), aug.movedim(-3, -2)], dim=-2)


def _resample_row_bytes(l: int) -> int:
    # positions and fractions (f32), block and tap indices (i32), two int64
    # gathers, two taps, the output and the padded row
    return 64 * l


def _pv_row_bytes(l: int, f_upper: float, n_fft: int = 1024, hop: int = 256) -> int:
    """Frames, their spectrum, magnitude and phase over ``T`` frames; the
    gathered and interpolated bins, the phase accumulator and the
    synthesised frames over ``out_t`` frames; the stretched buffer."""
    _, t_frames, out_t, buf_len, _ = _pv_tables(l, float(f_upper), n_fft, hop)
    k = n_fft // 2 + 1
    return 4 * (t_frames * (n_fft + 4 * k) + out_t * (12 * k + 3 * n_fft) + 3 * buf_len)
