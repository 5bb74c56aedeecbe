"""``examples_torch/quantize_and_eval.py`` against the reference's
``examples/quantize_and_eval.py`` on the CPU, at ``--train-steps 2``.

The port trains from the reference script's own initial parameters
(``lm.init_params(PRNGKey(0), smoke)`` through ``params_from_numpy``) on
the same data stream (``SyntheticLM`` is bit-equal in both packages).
Every printed eval loss (f32, Q8..Q2, the allocated mix) must be within
LOSS_TOL of the reference's, each delta within twice that and the
training loss within TRAIN_TOL;
the compression and projection columns must be the reference's text.

Two parts of the reference's run are computed by the port, for the time
(~60 s of the reference's ~75 s are eager XLA compiles): its
``quantize_params`` (``port_quantize``: bit-equal) and, inside its
``calibrate_policy``, the output-sensitivity probes, handed to the
reference's solver as ``scores=`` (the probes are held score by score in
``tests/test_torch_planner.py``).  The reference's solver picks the mix
row's allocation and its own ``loss_fn`` evaluates every row."""
import re

import jax
import numpy as np
import torch

import repro.configs as JC
import repro_torch.configs as TC
from repro.core import sensitivity as jsens
from repro.models import lm as jlm
from repro_torch.convert import params_from_numpy
from repro_torch.core import sensitivity as tsens
from repro_torch.models import sail_linear as tsl

from _torch_examples import (load, one_torch_thread,  # noqa: F401
                             printed, port_quantize, refuses_missing_cuda,
                             run_reference)

ARCH = "llama3_2_1b"           # the script's default
ARGV = ["--train-steps", "2"]
# printed losses (4 decimals, ~12-14): two f32 training steps apart in
# summation order, then each eval's own rounding to the printed digits
LOSS_TOL = 2e-4
TRAIN_TOL = 1e-3               # the training line prints 3 decimals
ROW = re.compile(r"(Q ?\d|f32|mix) +(-?[\d.]+) +([-+][\d.]+|-) +([\d.]+x)"
                 r" +(.*)")


def _carried(params):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                             device="cpu")


def _port_scores(monkeypatch):
    """The reference's calibrate_policy with the port's probes as its
    ``scores``."""
    solve = jsens.calibrate_policy

    def calibrate(params, cfg, policy, tokens, **kw):
        scores = tsens.output_sensitivity(
            _carried(params), TC.get_smoke(ARCH),
            torch.from_numpy(np.array(tokens)),
            tsl.QuantPolicy.from_spec(policy.to_spec()))
        return solve(params, cfg, policy, tokens=tokens, scores=scores, **kw)
    monkeypatch.setattr(jsens, "calibrate_policy", calibrate)


def _rows(lines):
    return {m.group(1): m.groups()[1:]
            for m in map(ROW.fullmatch, lines) if m}


def test_quantize_and_eval_prints_the_reference_losses(monkeypatch):
    ref = load("examples", "quantize_and_eval")
    monkeypatch.setattr(ref, "quantize_params", port_quantize)
    _port_scores(monkeypatch)
    want = run_reference(ref, ARGV, monkeypatch)
    port = load("examples_torch", "quantize_and_eval")
    args = port.parse_args(ARGV + ["--device", "cpu"])
    init = _carried(jlm.init_params(jax.random.PRNGKey(0),
                                    JC.get_smoke(ARCH)))
    _, got = printed(port.run, init, TC.get_smoke(ARCH), args,
                     torch.device("cpu"))
    assert len(got) == len(want) == 11
    g_loss = float(got[0].rsplit(" ", 1)[1])
    w_loss = float(want[0].rsplit(" ", 1)[1])
    assert abs(g_loss - w_loss) <= TRAIN_TOL, (got[0], want[0])
    assert got[2] == want[2]                      # the header
    g_rows, w_rows = _rows(got), _rows(want)
    assert list(g_rows) == list(w_rows) == ["f32", "Q 8", "Q 6", "Q 5",
                                            "Q 4", "Q 3", "Q 2", "mix"]
    for name, (loss, delta, comp, rest) in g_rows.items():
        w_loss, w_delta, w_comp, w_rest = w_rows[name]
        assert abs(float(loss) - float(w_loss)) <= LOSS_TOL, name
        if delta != "-":
            assert abs(float(delta) - float(w_delta)) <= 2 * LOSS_TOL, name
        assert (comp, rest) == (w_comp, w_rest), name


def test_quantize_and_eval_refuses_a_missing_cuda_device(monkeypatch):
    refuses_missing_cuda(load("examples_torch", "quantize_and_eval"),
                         monkeypatch)
