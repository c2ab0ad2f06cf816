"""Packed stores (device-resident and host-resident), the episodic samplers,
the host-to-card staging and the reference-layout dataset loader.

The names the JAX package's ``data`` exports. ``pack_dataset`` is the
bring-your-own-data entry point: any indexable ``(array, label)`` sequence
packs into a ``PackedStore`` on the card (or where ``device`` says).
"""

from typing import Sequence, Union

import numpy as np
import torch

from audio_few_shot_learning_tpu_torch.data.datasets import (  # noqa: F401
    MetaAudioDataset,
    load_packed_split,
    make_synthetic_dataset,
    make_synthetic_wav_dataset,
)
from audio_few_shot_learning_tpu_torch.data.episodes import (  # noqa: F401
    EpisodeBatch,
    sample_episode,
    sample_episode_batch,
)
from audio_few_shot_learning_tpu_torch.data.hoststore import HostStore  # noqa: F401
from audio_few_shot_learning_tpu_torch.data.store import PackedStore
from audio_few_shot_learning_tpu_torch.data.wavhoststore import WavHostStore  # noqa: F401
from audio_few_shot_learning_tpu_torch.data.wavstore import PackedWavStore  # noqa: F401
from audio_few_shot_learning_tpu_torch.device import resolve_device


def pack_dataset(
    dataset: Sequence, mean: float = 0.0, std: float = 1.0, device: Union[str, torch.device, None] = None
) -> PackedStore:
    """Pack any indexable ``(x, label)`` dataset into a ``PackedStore``
    z-scored with ``(mean, std)`` (JAX ``pack_dataset``, data/__init__.py:31;
    the adapter role of the reference's datasets/few_shot_dataset.py)."""
    items = [np.asarray(dataset[i][0]) for i in range(len(dataset))]
    labels = [int(dataset[i][1]) for i in range(len(dataset))]
    return PackedStore.pack(items, labels, mean=mean, std=std, device=resolve_device(device))
