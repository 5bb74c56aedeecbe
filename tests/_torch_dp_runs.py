"""Shared by ``tests/test_torch_dp.py`` and ``tests/test_torch_dp_train.py``:
their inputs (numpy weights, batches, gradients, made from seeds) and one
run of each side, the port's gloo ranks (``tests/_torch_dp_ranks.py``)
beside reference processes with eight JAX host devices."""
import os
import pickle
import subprocess
import sys

import numpy as np

import _torch_dp_ranks as ranks
import repro.configs as JC
import repro_torch.configs as TC
from repro_torch.data.pipeline import DataConfig, SyntheticLM

from _torch_models import numpy_params

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SRC = os.path.join(ROOT, "src")
TIMEOUT_S = 300


def env(**extra):
    out = dict(os.environ, **extra)
    out["PYTHONPATH"] = SRC + os.pathsep + out.get("PYTHONPATH", "")
    return out


def make_inputs():
    """{config: (numpy weights, the train steps' global batches, a masked
    batch whose mask is dense on the first half of the rows and sparse on
    the second), "compress": two gradient trees}."""
    out = {}
    for arch, (b, t) in ranks.SHAPES.items():
        cfg = TC.get_smoke(arch)
        data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=t,
                                      global_batch=b))
        batches = [data.next_batch() for _ in range(ranks.STEPS)]
        mb, mt = ranks.MASKED[arch]
        rng = np.random.default_rng(3)
        mask = (rng.random((mb, mt)) < np.where(
            np.arange(mb)[:, None] < mb // 2, 0.9, 0.2)).astype(np.float32)
        masked = dict(tokens=rng.integers(0, cfg.vocab, (mb, mt + 1)).astype(
            np.int32), mask=mask)
        out[arch] = (numpy_params(JC.get_smoke(arch)), batches, masked)
    rng = np.random.default_rng(7)
    rows = 4 * ranks.COMPRESS_ROWS
    out["compress"] = [
        {"w": rng.standard_normal((rows, 64)).astype(np.float32),
         "b": (rng.standard_normal((rows, 4)) * 1e-3).astype(np.float32)}
        for _ in range(2)]
    return out


def run_both(tmp, part, codes):
    """Part ``part`` of the rank script and the reference programs
    ``codes`` (each run with the inputs' path and its output path), side
    by side: (inputs, [each reference program's results], {(world, rank):
    the port's})."""
    inputs = make_inputs()
    inputs_path = str(tmp / "inputs.pkl")
    with open(inputs_path, "wb") as f:
        pickle.dump(inputs, f)
    procs = []
    for i, code in enumerate(codes):
        out = str(tmp / f"reference{i}.pkl")
        procs.append((out, subprocess.Popen(
            [sys.executable, "-c", code, inputs_path, out],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env(XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8"),
                    OMP_NUM_THREADS="1"))))
    try:
        port = subprocess.run(
            [sys.executable, ranks.__file__, str(tmp), inputs_path, part],
            capture_output=True, text=True, env=env(OMP_NUM_THREADS="1"),
            timeout=TIMEOUT_S)
        errs = [p.communicate(timeout=TIMEOUT_S)[1] for _, p in procs]
    finally:
        for _, p in procs:
            p.kill()
    assert port.returncode == 0, port.stderr[-3000:]
    want = []
    for (out, p), err in zip(procs, errs):
        assert p.returncode == 0, err[-3000:]
        with open(out, "rb") as f:
            want.append(pickle.load(f))
    got = {}
    for world in (2, 4):
        for r in range(world):
            with open(tmp / f"w{world}_rank{r}.pkl", "rb") as f:
                got[(world, r)] = pickle.load(f)
    return inputs, want, got
