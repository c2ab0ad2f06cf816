"""Where the port runs: the card unless the caller asks for the CPU, and at
what float32 precision: on the card TF32 is off for cuBLAS and cuDNN, so
that a float32 config computes in float32, as the JAX reference does on
its CPU and as every card-vs-CPU check holds it (cuDNN's default would run
float32 convolutions and the Hybrid's recurrent layer, float32 after the
conv stack in every config, in TF32)."""

from __future__ import annotations

from typing import Union

import torch
import torch.distributed as dist

from audio_few_shot_learning_tpu_torch.config import ExperimentConfig
from audio_few_shot_learning_tpu_torch.parallel.mesh import local_rank


def resolve_device(device: Union[str, torch.device, None] = None) -> torch.device:
    """``device`` if given, else card 0; for a card, TF32 off for cuBLAS
    matmuls and cuDNN (convolutions, RNNs). Raises rather than running on
    the CPU when the card is asked for and none is present."""
    device = torch.device("cuda:0" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' or set \"device\": \"cpu\" "
                "in the experiment config to run on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device


def config_device(exp: ExperimentConfig, device: Union[str, torch.device, None] = None) -> torch.device:
    """``device`` if given, else the CPU when the config says ``"cpu"``, else
    the card ``exp.gpu_index``, or in a process group of more than one rank
    this rank's card, ``cuda:LOCAL_RANK``; raises as ``resolve_device``
    does."""
    if device is None:
        if exp.device == "cpu":
            device = "cpu"
        elif dist.is_initialized() and dist.get_world_size() > 1:
            device = f"cuda:{local_rank()}"
        else:
            device = f"cuda:{exp.gpu_index}"
    return resolve_device(device)
