"""Device selection for the port's entry points: the GPU unless the caller
asks for the CPU, and never a silent fallback."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """`None` means `cuda`. A CUDA device without a visible GPU raises: the
    CPU is used only when the caller names it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "vits_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run on the CPU")
    return dev
