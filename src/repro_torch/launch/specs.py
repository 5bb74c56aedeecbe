"""Input and cache stand-ins for every (arch x shape) cell (port of
``repro.launch.specs``): tensors on torch's ``meta`` device, which carry a
shape and a dtype and allocate nothing, where the reference has
``jax.ShapeDtypeStruct``.

Shapes:
  train_4k     seq 4096,   global_batch 256   -> the train step
  prefill_32k  seq 32768,  global_batch 32    -> a prefill step
  decode_32k   seq 32768,  global_batch 128   -> a serve step (1 new token)
  long_500k    seq 524288, global_batch 1     -> a serve step, sub-quadratic
                                                 archs only

Frontend stubs: whisper gets frame embeddings [B, S, D] (the conv stub's
output), phi-3-vision gets its patch embeddings ahead of the text tokens.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.models import encdec, lm
from repro_torch.models.common import ModelConfig

SHAPES = {
    "train_4k": dict(seq=4096, batch=256, kind="train"),
    "prefill_32k": dict(seq=32768, batch=32, kind="prefill"),
    "decode_32k": dict(seq=32768, batch=128, kind="decode"),
    "long_500k": dict(seq=524288, batch=1, kind="decode"),
}

# archs whose decode state is sub-quadratic (SWA window / recurrent state)
LONG_CONTEXT_OK = {"h2o-danube-3-4b", "hymba-1.5b", "mixtral-8x7b",
                   "xlstm-350m", "tinymistral-248m"}


def cell_is_runnable(cfg: ModelConfig, shape: str) -> bool:
    if shape == "long_500k":
        return cfg.name in LONG_CONTEXT_OK or (
            cfg.window is not None or cfg.family in ("ssm",))
    return True


def meta(shape, dtype) -> torch.Tensor:
    """An unallocated tensor of ``shape`` and ``dtype``."""
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: str) -> Dict[str, Any]:
    """The cell's step inputs as meta tensors: int32 tokens, f32 frames
    and prefix embeddings."""
    s = SHAPES[shape]
    seq, batch, kind = s["seq"], s["batch"], s["kind"]
    d = cfg.d_model

    if kind == "train":
        if cfg.family == "encdec":
            return {"frames": meta((batch, cfg.enc_seq, d), torch.float32),
                    "tokens": meta((batch, seq + 1), torch.int32)}
        b: Dict[str, Any] = {"tokens": meta((batch, seq + 1), torch.int32)}
        if cfg.frontend == "vision":
            b["prefix_embeds"] = meta((batch, cfg.vision_tokens, d),
                                      torch.float32)
        return b

    if kind == "prefill":
        if cfg.family == "encdec":
            # the encoder takes the long sequence (long-form audio)
            return {"frames": meta((batch, seq, d), torch.float32)}
        b = {"tokens": meta((batch, seq), torch.int32),
             "lengths": meta((batch,), torch.int32)}
        if cfg.frontend == "vision":
            b["prefix_embeds"] = meta((batch, cfg.vision_tokens, d),
                                      torch.float32)
        return b

    # decode: one token against a cache of `seq`
    return {"tokens": meta((batch, 1), torch.int32)}


def decode_cache_len(cfg: ModelConfig, shape: str) -> int:
    seq = SHAPES[shape]["seq"]
    if cfg.family == "ssm":
        return 0
    if cfg.window is not None:
        return min(seq, cfg.window)
    return seq


def cache_specs(cfg: ModelConfig, shape: str, quant_kv: bool = True):
    """The decode cache of the cell, built by ``lm.init_cache`` /
    ``encdec.init_dec_cache`` on the meta device."""
    batch = SHAPES[shape]["batch"]
    clen = max(decode_cache_len(cfg, shape), 1)
    if cfg.family == "encdec":
        return encdec.init_dec_cache(cfg, batch, clen, cfg.enc_seq,
                                     quant_kv, device="meta")
    return lm.init_cache(cfg, batch, clen, quant_kv, device="meta")
