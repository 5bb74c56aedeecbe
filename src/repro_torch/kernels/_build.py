"""Build the CUDA kernels with ``nvcc`` at first use and load them with
``ctypes``.

Each ``csrc/<name>.cu`` becomes its own shared library with a plain C
interface, compiled for ``sm_90a``.  Libraries are keyed by a hash of
every source and header plus the flags, so an edit rebuilds and an
unchanged tree reuses the build.  ``build()`` starts one ``nvcc`` per
missing library, all at once, and waits for all of them.  Nothing here
runs at import time.

Every wrapper that launches a kernel adds one to ``launches[<kernel>]``
at the launch and nowhere else, so a run can show that its main path
went through the kernels (``reset_launches`` before, read after).  The
LUT-GEMV also counts each launch under its compiled instance,
``lut_instances[(bits, abits)]`` (abits 0: f32 activations), so a
mixed-precision run can show which instances served it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterable, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("typeconv", "lut_gemv", "decode_attn")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

launches: Dict[str, int] = {"lut_matmul": 0, "lut_matmul_int": 0,
                            "decode_attention": 0, "int_to_f32": 0,
                            # the table-mode share of decode_attention's
                            "decode_attention_table": 0}

lut_instances: Dict[Tuple[int, int], int] = {}

_LOADED: Dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0
    lut_instances.clear()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(fallback):
        return fallback
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "src/repro_torch/csrc at first use and need the CUDA "
                       "toolkit")


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest(name)}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every library in ``names`` that is not built yet, one
    ``nvcc`` per source, all started together.  Returns each newly built
    library's compiler log (``-Xptxas -v``: registers, shared memory,
    spills); raises with the log when a build fails."""
    missing = [n for n in names if not library_path(n).exists()]
    if not missing:
        return {}
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in missing:
        out = library_path(name)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs = {}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"nvcc failed for {name}.cu:\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The built library ``lib<name>``, building it first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _LOADED[name] = lib
    return lib


def route(t) -> str:
    """"cuda" for a CUDA tensor (launch the kernel), "cpu" for a CPU tensor
    (take the plain version); any other device raises."""
    kind = t.device.type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"no kernel or plain version for device {t.device}")
    return kind


def check(err: int, what: str) -> None:
    """Raise on a nonzero ``cudaGetLastError()`` returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")
