"""Where the port runs: the card unless the caller asks for the CPU."""

from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device, None] = None) -> torch.device:
    """``device`` if given, else card 0. Raises rather than running on the
    CPU when the card is asked for and none is present."""
    device = torch.device("cuda:0" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' or set \"device\": \"cpu\" "
            "in the experiment config to run on the CPU"
        )
    return device
