"""Architecture config registry: ``--arch <id>`` resolution.

Each module defines ``full()`` (the exact published configuration) and
``smoke()`` (a reduced same-family config for CPU tests).  The port has
every architecture of the reference, in its order: the decoders serve
through ``models.lm`` and the engine, whisper (``family="encdec"``)
through ``models.encdec``.
"""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.models.common import ModelConfig

ARCHS: List[str] = [
    "starcoder2_7b",
    "llama3_2_1b",
    "h2o_danube_3_4b",
    "qwen3_0_6b",
    "whisper_large_v3",
    "phi_3_vision_4_2b",
    "hymba_1_5b",
    "granite_moe_1b_a400m",
    "mixtral_8x7b",
    "xlstm_350m",
    # the paper's own evaluation models
    "llama2_7b",
    "llama2_13b",
    "tinymistral_248m",
]


def canon(name: str) -> str:
    return name.replace("-", "_").replace(".", "_")


def _module(name: str):
    arch = canon(name)
    if arch not in ARCHS:
        raise ValueError(f"unknown arch {name!r} (have {ARCHS})")
    return importlib.import_module(f"repro_torch.configs.{arch}")


def get_config(name: str) -> ModelConfig:
    return _module(name).full()


def get_smoke(name: str) -> ModelConfig:
    return _module(name).smoke()
