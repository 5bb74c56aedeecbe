"""Shared helpers of the example parity tests (tests/test_torch_example_*.py):
each loads the reference script (``examples/<name>.py``) and its port
(``examples_torch/<name>.py``) by path and captures what they print."""
import contextlib
import importlib.util
import io
import os
import sys

import jax
import numpy as np
import pytest
import torch

from repro_torch.convert import params_from_numpy
from repro_torch.models import sail_linear as tsl

from _torch_models import one_torch_thread, reference_tree  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load(folder: str, name: str):
    """``<folder>/<name>.py`` as a fresh module (the examples are scripts,
    not a package)."""
    path = os.path.join(ROOT, folder, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"_{folder}_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def printed(fn, *args, **kwargs):
    """(``fn(*args, **kwargs)``, the lines it printed)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn(*args, **kwargs)
    return result, out.getvalue().splitlines()


def run_reference(module, argv, monkeypatch):
    """The reference script's ``main()`` under ``sys.argv = [script] +
    argv``; returns the lines it printed."""
    monkeypatch.setattr(sys, "argv", [module.__file__] + list(argv))
    return printed(module.main)[1]


def refuses_missing_cuda(module, monkeypatch):
    """``main([])`` asks for CUDA and raises where torch sees none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main([])


def port_quantize(params, policy):
    """The reference's ``quantize_params(params, policy)`` computed by the
    port, as the reference's tree: the two quantize bit for bit
    (``tests/test_torch_plan.py``), and the reference's eager
    quantization takes seconds a tree."""
    carried = params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                                device="cpu")
    tq, b0, b1 = tsl.quantize_params(
        carried, tsl.QuantPolicy.from_spec(policy.to_spec()))
    return reference_tree(tq), b0, b1
