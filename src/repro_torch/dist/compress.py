"""int8 + per-tensor-scale compression of a tensor sent over the wire
(port of ``repro.dist.compress``, the part serving uses).

``_quantize_dequantize`` is the format ``tp_all_reduce`` sends at wire 8:
one absmax over the WHOLE tensor, ``scale = absmax / 127`` (1 / 127 for an
all-zero tensor), codes rounded half to even and clipped to +-127, and
the tensor comes back as ``codes * scale``.  Bit-equal to the reference.

The reference's gradient exchange with error feedback
(``make_compressed_allreduce``, ``init_error_state``) is training and
waits for the port's training slice (ROADMAP, Queue 1 item 5).
"""
from __future__ import annotations

import torch


def _quantize_dequantize(x: torch.Tensor) -> torch.Tensor:
    absmax = x.abs().amax()
    scale = torch.where(absmax == 0, torch.ones_like(absmax), absmax) / 127.0
    codes = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return codes.to(torch.float32) * scale
