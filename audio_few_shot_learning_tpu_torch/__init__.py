"""PyTorch/CUDA port of audio_few_shot_learning_tpu for NVIDIA Hopper.

Same module layout as the JAX package; the hot kernels are hand-written CUDA
C++ under ``csrc/``, built with ``nvcc`` at first use. This package imports
nothing of JAX or of the JAX package.
"""

from audio_few_shot_learning_tpu_torch.config import (  # noqa: F401
    ExperimentConfig,
    ModelConfig,
    load_configs,
)
