"""Device choice for the port's entry points."""

from __future__ import annotations

import os
from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The GPU unless the caller names a device: under torchrun the rank's
    own, ``cuda:LOCAL_RANK``. A CUDA device that is not there raises instead
    of falling back to the CPU."""
    if device is None:
        device = f"cuda:{os.environ['LOCAL_RANK']}" if "LOCAL_RANK" in os.environ else "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev
