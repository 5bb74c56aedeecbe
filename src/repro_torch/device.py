"""Device resolution for the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises when it names CUDA and no
    CUDA device is visible.  Entry points call this instead of silently
    running on the CPU: a caller who wants the CPU passes
    ``device="cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} requested but torch sees no CUDA device;"
            " pass device='cpu' to run the plain PyTorch path")
    return dev
