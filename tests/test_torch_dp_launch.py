"""The training launcher's ``--mesh`` and ``--distributed`` on the CPU:
``--mesh 2x1`` spawns two gloo ranks whose run equals the one-device
launcher's on the same global batches; its checkpoint (full arrays,
written by rank 0) resumes at dp 1 and dp 4; a model axis over a config
tensor parallelism cannot shard is refused;
``--distributed`` joins the group that torchrun's environment describes
(two processes on 127.0.0.1), each drawing its own host's batch."""
import os
import shutil
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import _msgpack
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch import train as ttrain
from repro_torch.launch.steps import build_train_step
from repro_torch.tree import tree_flatten_with_path

import repro_torch.configs as TC

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SRC = os.path.join(ROOT, "src")
TIMEOUT_S = 240
TOL = 1e-5                 # each checkpoint leaf, of its max
ARGS = ["--arch", "tinymistral_248m", "--smoke", "--device", "cpu",
        "--global-batch", "8", "--seq", "32"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's smoke-sized CPU ops are tiny: one intra-op thread runs
    them fastest, and keeps them off the other test workers' cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def launch(args, **env):
    """The launcher in a new process (spawned ranks print to its stdout)."""
    full = dict(os.environ, OMP_NUM_THREADS="1", **env)
    full["PYTHONPATH"] = SRC + os.pathsep + full.get("PYTHONPATH", "")
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train"] + args,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=full)


def finish(proc):
    out, err = proc.communicate(timeout=TIMEOUT_S)
    assert proc.returncode == 0, err[-3000:]
    return out


def checkpoint(directory, step):
    """{path: array} and extras of checkpoint ``step``."""
    d = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.msgpack"), "rb") as f:
        meta = _msgpack.unpackb(f.read())
    return ({rec["path"]: np.load(os.path.join(d, rec["id"] + ".npy"))
             for rec in meta["leaves"]}, meta["extras"])


def assert_same_run(got_dir, want_dir, step):
    got, gx = checkpoint(got_dir, step)
    want, wx = checkpoint(want_dir, step)
    assert gx == wx and sorted(got) == sorted(want)
    for path, w in want.items():
        g = got[path]
        assert g.shape == w.shape and g.dtype == w.dtype, path
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(g - w).max()) <= TOL * scale, path


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The one-device launcher to steps 4 and 6, and ``--mesh 2x1`` to
    step 4 (its process started first, so it runs beside them)."""
    tmp = tmp_path_factory.mktemp("launch")
    dirs = {k: str(tmp / k) for k in ("one4", "one6", "dp2")}
    proc = launch(ARGS + ["--mesh", "2x1", "--steps", "4", "--ckpt",
                          dirs["dp2"]])
    ttrain.main(ARGS + ["--steps", "4", "--ckpt", dirs["one4"]])
    ttrain.main(ARGS + ["--steps", "6", "--ckpt", dirs["one6"]])
    return tmp, dirs, finish(proc)


def test_mesh_2x1_equals_one_device(runs):
    _, dirs, out = runs
    assert "mesh {'data': 2, 'model': 1} on 2 ranks (gloo; this rank 0)" \
        in out
    assert out.count("finished at step 4 (preempted=False)") == 1
    assert sorted(os.listdir(dirs["dp2"])) == ["LATEST", "step_00000004"]
    assert_same_run(dirs["dp2"], dirs["one4"], 4)


def test_mesh_1x1_is_one_process(runs, capsys):
    """A mesh of one rank runs in this process, with no group and no
    collective, and equals the one-device run."""
    tmp, dirs, _ = runs
    ckpt = str(tmp / "dp1")
    ttrain.main(ARGS + ["--mesh", "1x1", "--steps", "4", "--ckpt", ckpt])
    assert "mesh {'data': 1, 'model': 1} on 1 ranks (none" in \
        capsys.readouterr().out
    assert_same_run(ckpt, dirs["one4"], 4)


def test_resumes_at_dp1_and_dp4(runs):
    """The dp 2 checkpoint at step 4 resumed to step 6 on one device and on
    four ranks: both equal the uninterrupted one-device run."""
    tmp, dirs, _ = runs
    dp1, dp4 = str(tmp / "resume1"), str(tmp / "resume4")
    shutil.copytree(dirs["dp2"], dp1)
    shutil.copytree(dirs["dp2"], dp4)
    proc = launch(ARGS + ["--mesh", "4x1", "--steps", "6", "--ckpt", dp4])
    ttrain.main(ARGS + ["--steps", "6", "--ckpt", dp1])
    out = finish(proc)
    assert "resumed from step 4" in out and "on 4 ranks" in out
    assert_same_run(dp1, dirs["one6"], 6)
    assert_same_run(dp4, dirs["one6"], 6)


def test_model_axis_is_refused():
    """A model axis over a config that does not train tensor-parallel yet
    (xlstm's recurrent state, ROADMAP Queue 1 item 5d (ii)) is refused
    before any rank starts."""
    args = ARGS[:]
    args[args.index("tinymistral_248m")] = "xlstm_350m"
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ttrain.main(args + ["--mesh", "1x2", "--steps", "1"])


def test_distributed_joins_the_environments_group(tmp_path):
    """Two processes with torchrun's variables on 127.0.0.1: each host
    draws its own batch (``n_hosts`` 2), so the run equals one device on
    the two hosts' batches stacked, rank 0's rows first."""
    ckpt = str(tmp_path / "ck")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [launch(ARGS + ["--distributed", "--steps", "3", "--ckpt", ckpt],
                    RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE="2",
                    MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
             for r in range(2)]
    outs = [finish(p) for p in procs]
    assert "on 2 ranks (gloo" in outs[0] and outs[1] == ""
    cfg = TC.get_smoke("tinymistral_248m")
    hosts = [SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=32,
                                    global_batch=8, n_hosts=2, host_id=h))
             for h in range(2)]
    built = build_train_step(cfg, microbatches=1, bf16_compute=False,
                             device="cpu")
    params = built.meta["init"](cfg, torch.Generator().manual_seed(0),
                                device="cpu")
    opt_state = built.meta["optimizer"].init(params)
    for _ in range(3):
        parts = [h.next_batch() for h in hosts]
        batch = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
        params, opt_state, _ = built.fn(params, opt_state, batch)
    got, extras = checkpoint(ckpt, 3)
    assert extras["step"] == 3
    for path, p in tree_flatten_with_path((params, opt_state)):
        w = p.numpy()
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(got[path] - w).max()) <= TOL * scale, path
