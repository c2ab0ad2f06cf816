"""Host-resident ragged waveform store.

Counterpart of the JAX package's ``data/wavhoststore.py``: the wav twin of
``HostStore`` (``data/hoststore.py``), for wav splits that do not fit on the
card beside the training program, or that pass the device store's int32
sample addressing (``data/wavstore.py``): ~29 GB of VoxCeleb in float32,
~60 GB of BirdClef in float16. The split's samples stay in host RAM in one
flat ragged buffer addressed with int64 offsets, followed by the tail rows,
as ``PackedWavStore`` lays them out; the host sampler draws episodes with
the JAX package's numpy calls, and only the assembled raw-wav batch goes to
the card, where WaveAugment, the online log-mel (K3) and the z-norm run as
on the device-store path.

Segments follow the reference's rules (datasets/batch_creation.py:173-209):
a full segment is a contiguous slice; the tail of a long item is its prefix
(``tile(whole)[:L]``); a short item takes its precomputed tiled row. All
three are rows of one sliding-window view of the buffer, so a batch is one
gather of windows straight into the staging buffer: no loop per row and no
float32 copy of a float16 store.

Storage is float32 (bit-exact with float32 files) or float16, which halves
host RAM and keeps 16-bit PCM within 2^-11; ``'bfloat16'`` (the spec stores'
half type, 8 mantissa bits: too coarse for raw samples) maps to float16.
A float16 batch goes to the card as float16 and is upcast there: the values
are the same.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence, Union

import numpy as np
import torch

from audio_few_shot_learning_tpu_torch.config import SAMPLE_RATE, SEGMENT_SECONDS
from audio_few_shot_learning_tpu_torch.data.hoststore import HostSampler
from audio_few_shot_learning_tpu_torch.data.wavstore import pack_wav_ragged


def resolve_wav_host_dtype(dtype) -> torch.dtype:
    """The wav host store's dtype for a config's store dtype: float32 or
    float16; bfloat16 means float16 here."""
    if isinstance(dtype, torch.dtype):
        name = str(dtype).split(".")[-1]
    else:
        name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    if name in ("bfloat16", "float16"):
        return torch.float16
    if name == "float32":
        return torch.float32
    raise ValueError(f"wav host store dtype must be float32/float16, got {dtype}")


def npy_1d_length(path) -> Optional[int]:
    """Sample count of a 1-D float32/float64 .npy from its header alone, or
    None for anything else."""
    try:
        with open(path, "rb") as f:
            version = np.lib.format.read_magic(f)
            read = np.lib.format.read_array_header_1_0 if version == (1, 0) else \
                np.lib.format.read_array_header_2_0
            shape, _, dtype = read(f)
    except (OSError, ValueError):
        return None
    if len(shape) != 1 or dtype not in (np.dtype(np.float32), np.dtype(np.float64)):
        return None
    return int(shape[0])


class WavHostStore(HostSampler):
    """Ragged waveforms in host RAM: ``buffer`` holds the ``n_samples``
    samples of every item, then one ``seg_len`` tail row per short item
    (one placeholder when there is none); int64 ``offsets``, ``lengths``,
    ``tail_index``; ``mean``/``std`` are the dataset's post-mel statistics."""

    zero_padding = False  # padded multi-segment rows repeat the item's last segment

    def __init__(self, buffer: torch.Tensor, n_samples: int, offsets, lengths, tail_index, seg_counts,
                 seg_len: int, labels, n_classes: int, mean: float = 0.0, std: float = 1.0):
        if buffer.device.type != "cpu" or buffer.dim() != 1 or not buffer.is_contiguous():
            raise ValueError("a WavHostStore keeps its samples in one contiguous 1-D CPU tensor")
        self.buffer = buffer
        self.n_samples = int(n_samples)
        self.offsets = np.asarray(offsets, np.int64)
        self.lengths = np.asarray(lengths, np.int64)
        self.tail_index = np.asarray(tail_index, np.int64)
        self.seg_len = int(seg_len)
        self.mean, self.std = float(mean), float(std)
        self._index(labels, n_classes, seg_counts)

    @property
    def flat(self) -> torch.Tensor:
        return self.buffer[: self.n_samples]

    @property
    def tails(self) -> torch.Tensor:
        return self.buffer[self.n_samples:].view(-1, self.seg_len)

    @property
    def feat_shape(self):
        return (self.seg_len,)

    @property
    def dtype(self) -> torch.dtype:
        return self.buffer.dtype

    def nbytes(self) -> int:
        return self.buffer.numel() * self.buffer.element_size()

    def window_starts(self, items: np.ndarray, segs: np.ndarray) -> np.ndarray:
        """Start in ``buffer`` of segment ``segs`` of item ``items`` (int64):
        the slice of a full segment, the item's prefix for the tail of a long
        item, or its tail row for a short item."""
        length = self.lengths[items]
        start = segs.astype(np.int64) * self.seg_len
        off = self.offsets[items]
        tail_row = self.n_samples + self.tail_index[items] * self.seg_len
        return np.where(length - start >= self.seg_len, off + start,
                        np.where(length < self.seg_len, tail_row, off))

    def gather(self, items: np.ndarray, segs: np.ndarray, out: torch.Tensor) -> None:
        """Rows ``[..., seg_len]`` into ``out`` (the store's dtype): one
        gather of windows of the buffer."""
        base = torch.from_numpy(self.window_starts(items, segs).reshape(-1))
        windows = self.buffer.unfold(0, self.seg_len, 1)  # [len(buffer) - seg_len + 1, seg_len]
        torch.ops.aten.index.Tensor_out(windows, [base], out=out.view(-1, self.seg_len))

    @staticmethod
    def pack(waveforms: Sequence[np.ndarray], labels: Sequence[int], n_classes: Optional[int] = None,
             mean: float = 0.0, std: float = 1.0, multi_segm: bool = False,
             segment_seconds: int = SEGMENT_SECONDS, sr: int = SAMPLE_RATE,
             dtype: Union[str, torch.dtype] = "float32") -> "WavHostStore":
        labels_np = np.asarray(labels, np.int32)
        if n_classes is None:
            n_classes = int(labels_np.max()) + 1 if len(labels_np) else 0
        flat, offsets, lengths, tails, tail_index, seg_counts, seg_len = pack_wav_ragged(
            waveforms, multi_segm, segment_seconds, sr)
        buffer = torch.from_numpy(np.concatenate([flat, tails.reshape(-1)])).to(resolve_wav_host_dtype(dtype))
        return WavHostStore(buffer, flat.shape[0], offsets, lengths, tail_index, seg_counts, seg_len,
                            labels_np, n_classes, mean, std)

    @staticmethod
    def pack_from_files(filepaths: Sequence[Union[str, Path]], labels: Sequence[int],
                        n_classes: Optional[int] = None, mean: float = 0.0, std: float = 1.0,
                        multi_segm: bool = False, segment_seconds: int = SEGMENT_SECONDS,
                        sr: int = SAMPLE_RATE, dtype: Union[str, torch.dtype] = "float32") -> "WavHostStore":
        """Two passes over the files: lengths from the .npy headers alone,
        then each file streamed into its slot of one buffer, so the peak is
        the buffer and one file. Irregular files (not 1-D float32/float64)
        take ``pack`` on the loaded list."""
        dtype = resolve_wav_host_dtype(dtype)
        labels_np = np.asarray(labels, np.int32)
        if n_classes is None:
            n_classes = int(labels_np.max()) + 1 if len(labels_np) else 0
        heads = [npy_1d_length(p) for p in filepaths]
        if any(h is None for h in heads):
            return WavHostStore.pack([np.load(p, allow_pickle=True) for p in filepaths], labels_np, n_classes,
                                     mean, std, multi_segm, segment_seconds, sr, dtype)
        lengths = np.asarray(heads, np.int64)
        l_max = int(lengths.max()) if len(lengths) else segment_seconds * sr
        seg_len = segment_seconds * sr if multi_segm else l_max
        offsets = np.zeros(len(lengths), np.int64)
        if len(lengths):
            offsets[1:] = np.cumsum(lengths)[:-1]
        n_samples = max(int(lengths.sum()), seg_len)
        short = lengths < seg_len
        tail_index = np.where(short, np.cumsum(short) - 1, 0).astype(np.int64)
        n_tails = max(int(short.sum()), 1)
        buffer = torch.zeros(n_samples + n_tails * seg_len, dtype=dtype)
        tails = buffer[n_samples:].view(n_tails, seg_len)
        for i, p in enumerate(filepaths):
            w = torch.from_numpy(np.load(p).astype(np.float32, copy=False).ravel())
            buffer[offsets[i]: offsets[i] + w.shape[0]] = w
            if 0 < w.shape[0] < seg_len:  # an empty item keeps its silent row
                tails[tail_index[i]] = w.repeat(-(-seg_len // w.shape[0]))[:seg_len]
        if multi_segm:
            seg_counts = np.maximum(-(-lengths // seg_len), 1).astype(np.int32)
        else:
            seg_counts = np.ones(len(lengths), np.int32)
        return WavHostStore(buffer, n_samples, offsets, lengths, tail_index, seg_counts, seg_len,
                            labels_np, n_classes, mean, std)
