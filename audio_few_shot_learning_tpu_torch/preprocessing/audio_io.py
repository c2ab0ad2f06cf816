"""Audio decoding without librosa or pydub.

Counterpart of the JAX package's ``preprocessing/audio_io.py`` (a copy: the
port imports nothing of that package). WAV files decode through scipy;
other containers (mp3/ogg/flac) through an ``ffmpeg`` subprocess when one is
installed, as the reference's librosa-then-pydub fallback chain does
(offline_preprocessing/to_np_and_norm.py:54-65).
"""

from __future__ import annotations

import shutil
import subprocess
from pathlib import Path
from typing import Union

import numpy as np
import scipy.io.wavfile
import scipy.signal


def _resample(x: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    if sr_in == sr_out:
        return x
    g = np.gcd(sr_in, sr_out)
    return scipy.signal.resample_poly(x, sr_out // g, sr_in // g).astype(np.float32)


def _to_float_mono(data: np.ndarray) -> np.ndarray:
    if data.ndim == 2:
        data = data.mean(axis=1)
    if data.dtype == np.int16:
        return (data / 32768.0).astype(np.float32)
    if data.dtype == np.int32:
        return (data / 2147483648.0).astype(np.float32)
    if data.dtype == np.uint8:
        return ((data.astype(np.float32) - 128.0) / 128.0).astype(np.float32)
    return data.astype(np.float32)


def load_audio(path: Union[str, Path], sr: int = 16000) -> np.ndarray:
    """Decode any audio file to mono float32 at the target sample rate."""
    path = Path(path)
    if path.suffix.lower() == ".wav":
        try:
            sr_in, data = scipy.io.wavfile.read(path)
            return _resample(_to_float_mono(np.asarray(data)), sr_in, sr)
        except ValueError:
            pass  # exotic wav encodings fall through to ffmpeg
    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg is None:
        raise RuntimeError(
            f"cannot decode {path}: not a plain WAV and ffmpeg is unavailable"
        )
    out = subprocess.run(
        [ffmpeg, "-v", "error", "-i", str(path), "-f", "f32le", "-ac", "1", "-ar", str(sr), "-"],
        capture_output=True,
        check=True,
    )
    return np.frombuffer(out.stdout, dtype=np.float32).copy()
