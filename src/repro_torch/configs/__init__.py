"""Architecture config registry: ``--arch <id>`` resolution.

Each module defines ``full()`` (the exact published configuration) and
``smoke()`` (a reduced same-family config for CPU tests).  The port has
the paper's small evaluation model so far; the other architectures wait
for ROADMAP's other families (``llama2_7b`` / ``llama2_13b`` first).
"""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.models.common import ModelConfig

ARCHS: List[str] = ["tinymistral_248m"]


def canon(name: str) -> str:
    return name.replace("-", "_").replace(".", "_")


def _module(name: str):
    arch = canon(name)
    if arch not in ARCHS:
        raise ValueError(f"arch {name!r} is not ported yet (have {ARCHS}); "
                         "see ROADMAP, other families")
    return importlib.import_module(f"repro_torch.configs.{arch}")


def get_config(name: str) -> ModelConfig:
    return _module(name).full()


def get_smoke(name: str) -> ModelConfig:
    return _module(name).smoke()
