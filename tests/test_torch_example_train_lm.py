"""``examples_torch/train_lm.py`` against the reference's
``examples/train_lm.py`` on the CPU.

At ``--steps 10`` (tiny preset: the smoke llama3_2_1b with the chunked
attention at chunk 64) the port trains from the reference script's own
initial parameters (``lm.init_params(PRNGKey(0), cfg)`` through
``params_from_numpy``) on the same data stream: every logged loss (steps 5
and 10) within LOSS_RTOL of the reference's and the other lines the
reference's.  Resume: 6 steps to a checkpoint, then a second run to step
10 from it, ends at the uninterrupted 10-step run's loss within
RESUME_RTOL.  The 100m preset's microbatches are the reference's
``auto_microbatches`` at train_4k (8)."""
import dataclasses
import re
import signal

import jax
import numpy as np
import pytest
import torch

from repro.launch.mesh import make_mesh as j_make_mesh
from repro.launch.steps import auto_microbatches as j_auto_microbatches
from repro.models import lm as jlm
from repro_torch.convert import params_from_numpy

from _torch_examples import (load, one_torch_thread,  # noqa: F401
                             printed, refuses_missing_cuda, run_reference)

ARGV = ["--steps", "10"]
LOSS_RTOL = 1e-5         # ten f32 AdamW steps apart in summation order
RESUME_RTOL = 1e-6
STEP = re.compile(r"\[train\] step (\d+): loss ([\d.]+) gnorm ([\d.]+) .*")


@pytest.fixture(autouse=True)
def own_signal_handlers():
    """Both scripts install the loop's SIGTERM / SIGINT handlers; the test
    process keeps its own."""
    saved = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    yield
    for s, handler in saved.items():
        signal.signal(s, handler)


def _recording(loop_cls, results):
    """``loop_cls`` whose ``run`` also appends its result to ``results``."""
    class Recording(loop_cls):
        def run(self):
            results.append(super().run())
            return results[-1]
    return Recording


def test_train_lm_logs_the_reference_losses(monkeypatch):
    ref = load("examples", "train_lm")
    ref_results = []
    monkeypatch.setattr(ref, "TrainLoop", _recording(ref.TrainLoop,
                                                     ref_results))
    want = run_reference(ref, ARGV, monkeypatch)
    port = load("examples_torch", "train_lm")
    args = port.parse_args(ARGV + ["--device", "cpu"])
    cfg = port.preset_cfg(args.preset, args.arch)
    jcfg = ref.preset_cfg(args.preset, args.arch)
    assert cfg.attn_chunk == jcfg.attn_chunk == 64
    raw = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, raw),
                               device="cpu")

    def run():
        built = port.build(cfg, torch.device("cpu"))
        assert built.meta["microbatches"] == 1
        return port.train(built, params, cfg, args)
    result, got = printed(run)
    assert len(got) == len(want) == 5
    assert got[:2] == want[:2]       # "training ... on 1 device(s)", params
    (w_result,) = ref_results
    assert [r["step"] for r in result["log"]] == \
        [r["step"] for r in w_result["log"]] == [5, 10]
    for g, w in zip(result["log"], w_result["log"]):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"],
                                   rtol=1e-4)
    for g, w in zip(got[2:4], want[2:4]):
        assert STEP.fullmatch(g).group(1) == STEP.fullmatch(w).group(1)
    assert got[4].split("  ")[0] == want[4].split("  ")[0] == "done: step 10"


def test_train_lm_resumes_to_the_uninterrupted_loss(tmp_path):
    port = load("examples_torch", "train_lm")
    ckpt = str(tmp_path / "ckpt")
    first, _ = printed(port.main, ["--device", "cpu", "--steps", "6",
                                   "--ckpt", ckpt])
    assert first["final_step"] == 6
    resumed, lines = printed(port.main, ["--device", "cpu", "--steps", "10",
                                         "--ckpt", ckpt])
    assert "resumed from step 6" in lines
    whole, _ = printed(port.main, ["--device", "cpu", "--steps", "10"])
    assert resumed["final_step"] == whole["final_step"] == 10
    np.testing.assert_allclose(resumed["log"][-1]["loss"],
                               whole["log"][-1]["loss"], rtol=RESUME_RTOL)


def test_train_lm_100m_microbatches_are_the_reference_count():
    port = load("examples_torch", "train_lm")
    ref = load("examples", "train_lm")
    cfg, jcfg = port.preset_cfg("100m", "x"), ref.preset_cfg("100m", "x")
    shared = set(dataclasses.asdict(cfg)) & set(dataclasses.asdict(jcfg))
    assert {k: getattr(cfg, k) for k in shared} == \
        {k: getattr(jcfg, k) for k in shared}
    want = j_auto_microbatches(jcfg, j_make_mesh((1, 1), ("data", "model")),
                               "train_4k")
    built, _ = printed(port.build, cfg, torch.device("cpu"))
    assert built.meta["microbatches"] == want == 8


def test_train_lm_refuses_a_missing_cuda_device(monkeypatch):
    refuses_missing_cuda(load("examples_torch", "train_lm"), monkeypatch)
