"""Device resolution for the port's entry points.

The default is the GPU. Without one, an entry point raises instead of
falling back to the CPU quietly; the CPU runs only when the caller asks for
it (``device="cpu"``), as the tests do.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """``None`` or ``"cuda"`` -> the current CUDA device; raises if CUDA is
    absent. Any explicit device is returned as a ``torch.device``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: mlagg_unet_torch runs on the GPU by "
                "default; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
