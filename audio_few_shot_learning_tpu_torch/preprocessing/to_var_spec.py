"""Variable-length waveforms -> stacked multi-segment log-mel spectrograms.

Counterpart of the JAX package's ``preprocessing/to_var_spec.py``, after the
reference's offline_preprocessing/to_var_spec.py:79-146: each waveform is cut
into ``length_s``-second segments; a short file repeats up to one segment,
and a trailing remainder repeats the *whole* sample and clips (the
reference's to_var_spec.py:117-121 / batch_creation.py:201-208, where the
tail restarts from the sample's beginning). Output ``[S, n_mels, frames]``,
one offline ``MelSpec`` call per file (K3 on the card).

The writers run on the card unless given ``device="cpu"``; with no card and
no such request they raise.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import List, Union

import numpy as np
import torch

from audio_few_shot_learning_tpu_torch.config import (
    HOP_LENGTH,
    MEL_POWER,
    N_FFT,
    N_MELS,
    SAMPLE_RATE,
    SEGMENT_SECONDS,
)
from audio_few_shot_learning_tpu_torch.device import resolve_device
from audio_few_shot_learning_tpu_torch.ops.mel import MelSpec


def variable_splits(sample: np.ndarray, length_s: int = SEGMENT_SECONDS, sr: int = SAMPLE_RATE) -> List[np.ndarray]:
    """Segment a 1-D waveform (reference batch_creation.py:173-209 /
    to_var_spec.py:87-121, the whole-sample tail repeat included)."""
    expected = length_s * sr
    splits: List[np.ndarray] = []
    n = sample.shape[0]
    if n < expected:
        reps = int(np.ceil(expected / n))
        splits.append(np.tile(sample, reps)[:expected])
        return splits
    start = 0
    while start < n:
        to_end = n - start
        if to_end >= expected:
            splits.append(sample[start : start + expected])
            start += expected
        else:
            # the reference repeats the WHOLE sample for the tail, not the remainder
            reps = int(np.ceil(expected / to_end))
            splits.append(np.tile(sample, reps)[:expected])
            start = n
    return splits


def stacked_spec(
    sample: np.ndarray,
    mel: MelSpec,
    length_s: int = SEGMENT_SECONDS,
    sr: int = SAMPLE_RATE,
    device: Union[str, torch.device, None] = None,
) -> np.ndarray:
    """``[L]`` -> ``[S, n_mels, frames]`` stacked log-mel segments,
    NaN-scrubbed first (to_var_spec.py:67); one ``mel`` call on ``device``."""
    device = resolve_device(device)
    segs = np.stack(variable_splits(np.nan_to_num(sample), length_s, sr))
    return mel(torch.from_numpy(segs).to(device)).cpu().numpy().astype(np.float32)


def npy_dir_to_var_spec(
    old_dir: Union[str, Path],
    new_dir: Union[str, Path],
    length_s: int = SEGMENT_SECONDS,
    sr: int = SAMPLE_RATE,
    n_mels: int = N_MELS,
    n_fft: int = N_FFT,
    hop_length: int = HOP_LENGTH,
    power: float = MEL_POWER,
    log_fn=print,
    device: Union[str, torch.device, None] = None,
) -> int:
    """Every class folder of waveforms to stacked log-mel files; an empty or
    constant file is skipped. Returns the number of files written."""
    device = resolve_device(device)
    old_dir, new_dir = Path(old_dir), Path(new_dir)
    new_dir.mkdir(parents=True, exist_ok=True)
    mel = MelSpec(flavor="offline", sr=sr, n_fft=n_fft, hop_length=hop_length, n_mels=n_mels, power=power)
    written = 0
    for cls in sorted(os.listdir(old_dir)):
        cdir = old_dir / cls
        if not cdir.is_dir():
            continue
        out_cdir = new_dir / cls
        out_cdir.mkdir(exist_ok=True)
        for fname in sorted(os.listdir(cdir)):
            if not fname.endswith(".npy"):
                continue
            audio = np.load(cdir / fname)
            if audio.shape[0] == 0 or np.std(audio) == 0.0:
                log_fn(f"Skipping degenerate file: {cdir / fname}")
                continue
            np.save(out_cdir / fname, stacked_spec(audio, mel, length_s, sr, device))
            written += 1
    return written
