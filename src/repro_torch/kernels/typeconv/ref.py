"""Plain versions of the Algorithm-1 conversion kernel.

``int_to_f32_plain`` runs Algorithm 1 line by line in PyTorch (the
kernel's own arithmetic, used for CPU tensors); ``int_to_f32_ref`` is the
native conversion both must match bit for bit."""
import torch

from repro_torch.core.typeconv import int_to_f32 as int_to_f32_plain

__all__ = ["int_to_f32_plain", "int_to_f32_ref"]


def int_to_f32_ref(a: torch.Tensor) -> torch.Tensor:
    """Native conversion — the ground truth Algorithm 1 must match."""
    return a.to(torch.float32)
