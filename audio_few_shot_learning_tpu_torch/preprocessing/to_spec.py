"""Fixed-length npy waveforms -> log-mel spectrogram npy files.

Counterpart of the JAX package's ``preprocessing/to_spec.py``, after the
reference's offline_preprocessing/to_spec.py:30-121 with its skip rules:
zero-std files, files shorter than 1 s, NaN files, and files of another
length than the one expected. Files of one class and one length go through
one offline ``MelSpec`` call, up to ``batch_size`` at a time (K3 on the card)
instead of a librosa call per file.

Runs on the card unless given ``device="cpu"``; with no card and no such
request it raises.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import List, Optional, Union

import numpy as np
import torch

from audio_few_shot_learning_tpu_torch.config import HOP_LENGTH, MEL_POWER, N_FFT, N_MELS, SAMPLE_RATE
from audio_few_shot_learning_tpu_torch.device import resolve_device
from audio_few_shot_learning_tpu_torch.ops.mel import MelSpec


def _should_skip(audio: np.ndarray, path, length: Optional[int], sr: int, log_fn) -> bool:
    if np.std(audio) == 0.0:
        log_fn(f"File has 0 std: {path}")
        return True
    if audio.shape[0] < sr:  # < 1 second (to_spec.py:45-46)
        return True
    if np.isnan(np.sum(audio)):
        return True
    if length is not None and audio.shape[0] != sr * length:
        log_fn(f"Unsuitable length: {audio.shape[0]}:: {path}")
        return True
    return False


def npy_dir_to_spec(
    old_dir: Union[str, Path],
    new_dir: Union[str, Path],
    sample_length: Optional[int],
    sr: int = SAMPLE_RATE,
    n_mels: int = N_MELS,
    n_fft: int = N_FFT,
    hop_length: int = HOP_LENGTH,
    power: float = MEL_POWER,
    batch_size: int = 64,
    log_fn=print,
    device: Union[str, torch.device, None] = None,
) -> int:
    """Every class folder of fixed-length waveforms to log-mel files.
    Returns the number of spectrograms written."""
    device = resolve_device(device)
    old_dir, new_dir = Path(old_dir), Path(new_dir)
    new_dir.mkdir(parents=True, exist_ok=True)
    mel = MelSpec(flavor="offline", sr=sr, n_fft=n_fft, hop_length=hop_length, n_mels=n_mels, power=power)
    written = 0

    def flush(batch: List[np.ndarray], paths: List[Path]):
        nonlocal written
        specs = mel(torch.from_numpy(np.stack(batch)).to(device)).cpu().numpy()  # [B, n_mels, frames]
        for spec, out_path in zip(specs, paths):
            np.save(out_path, spec.astype(np.float32))
            written += 1

    for cls in sorted(os.listdir(old_dir)):
        cdir = old_dir / cls
        if not cdir.is_dir():
            continue
        out_cdir = new_dir / cls
        out_cdir.mkdir(exist_ok=True)
        by_len = {}  # waveform length -> (waveforms, output paths)
        for fname in sorted(os.listdir(cdir)):
            if not fname.endswith(".npy"):
                continue
            audio = np.load(cdir / fname)
            if _should_skip(audio, cdir / fname, sample_length, sr, log_fn):
                continue
            batch, paths = by_len.setdefault(audio.shape[0], ([], []))
            batch.append(audio)
            paths.append(out_cdir / fname)
            if len(batch) >= batch_size:
                flush(batch, paths)
                by_len.pop(audio.shape[0])
        for batch, paths in by_len.values():
            flush(batch, paths)
    return written
