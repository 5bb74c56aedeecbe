"""Checkpoints of parameter trees (port of ``repro.checkpoint``; the
quantized-tree functions are still to port)."""
from repro_torch.checkpoint.checkpoint import (AsyncCheckpointer, keep_last,
                                               latest_step, restore, save)
