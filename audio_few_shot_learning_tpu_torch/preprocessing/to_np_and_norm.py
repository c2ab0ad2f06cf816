"""Raw audio -> mono 16 kHz z-normalized ``.npy`` (reference
offline_preprocessing/to_np_and_norm.py:43-149).

Counterpart of the JAX package's ``preprocessing/to_np_and_norm.py``."""

from __future__ import annotations

import os
from pathlib import Path
from typing import Union

import numpy as np

from audio_few_shot_learning_tpu_torch.preprocessing.audio_io import load_audio

AUDIO_EXTS = (".wav", ".mp3", ".ogg", ".flac", ".m4a")


def normalise(data: np.ndarray) -> np.ndarray:
    """Per-sample z-normalisation (to_np_and_norm.py:70-78)."""
    std = np.std(data)
    if std == 0:
        return data - np.mean(data)
    return (data - np.mean(data)) / std


def wav_dir_to_npy(
    old_dir: Union[str, Path],
    new_dir: Union[str, Path],
    sr: int = 16000,
    z_norm: bool = True,
    log_fn=print,
) -> int:
    """Convert a class-foldered audio tree to per-sample-normalized npy files.

    Class subfolders are kept; a file that fails to decode is skipped with a
    message (to_np_and_norm.py:100-149). Returns the number of files written.
    """
    old_dir, new_dir = Path(old_dir), Path(new_dir)
    new_dir.mkdir(parents=True, exist_ok=True)
    written = 0
    for cls in sorted(os.listdir(old_dir)):
        cdir = old_dir / cls
        if not cdir.is_dir():
            continue
        out_cdir = new_dir / cls
        out_cdir.mkdir(exist_ok=True)
        for fname in sorted(os.listdir(cdir)):
            if not fname.lower().endswith(AUDIO_EXTS):
                continue
            try:
                data = load_audio(cdir / fname, sr=sr)
            except Exception as e:  # a corrupt file is skipped; the rest go on
                log_fn(f"Cannot decode {cdir / fname}: {e}")
                continue
            if z_norm:
                data = normalise(data)
            np.save(out_cdir / (os.path.splitext(fname)[0] + ".npy"), data.astype(np.float32))
            written += 1
    return written
