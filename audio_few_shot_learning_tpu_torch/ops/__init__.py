"""Ops with hand-written CUDA kernels and their plain PyTorch versions.

The names the JAX package's ``ops`` exports, here with a ``torch.Generator``
where it takes a key. Importing builds no kernel: each is built at its first
launch (``ops/cuda_build.py``).
"""

from audio_few_shot_learning_tpu_torch.ops.mel import (  # noqa: F401
    MelSpec,
    log_mel_spectrogram,
    mel_filterbank,
)
from audio_few_shot_learning_tpu_torch.ops.protohead import (  # noqa: F401
    batched_episode_scores,
    compute_prototypes,
    pairwise_sqeuclidean,
    prototype_scores,
)
from audio_few_shot_learning_tpu_torch.ops.specaugment import (  # noqa: F401
    SpecAugment,
    spec_augment_views,
    time_warp,
)
