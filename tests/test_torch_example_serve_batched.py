"""``examples_torch/serve_batched.py`` against the reference's
``examples/serve_batched.py`` on the CPU, at ``--requests 3 --max-new 4``.

The port's serving function gets the reference script's own parameters
(``lm.init_params(PRNGKey(0), smoke)``, carried through
``params_from_numpy``); the prompts come from ``np.random.default_rng(0)``
on both sides.  The weights line (compression), the counts (requests,
tokens, model iterations), every printed request's token count and first
tokens, and the machine-model projection must be the reference's.  The
reference engine's quantization is the port's (``port_quantize``: the
two quantize bit for bit, and the reference's eager one takes seconds)."""
import re

import jax
import numpy as np
import torch

import repro.configs as JC
from repro.models import lm as jlm
from repro.serving import engine as jengine
from repro_torch.convert import params_from_numpy

from _torch_examples import (load, one_torch_thread,  # noqa: F401
                             port_quantize, printed, refuses_missing_cuda,
                             run_reference)

ARGV = ["--requests", "3", "--max-new", "4"]
SERVED = re.compile(r"served (\d+) requests / (\d+) tokens in .* measured "
                    r"on (.*), (\d+) model iterations, mean TTFT")
REQ = re.compile(r"  req (\d+): (\d+) tokens, latency .*s, first tokens "
                 r"(\[.*\])")


def _fields(line):
    """(the counts of a served line, the device it names)."""
    m = SERVED.search(line)
    return (m.group(1), m.group(2), m.group(4)), m.group(3)


def test_serve_batched_prints_the_reference_lines(monkeypatch):
    monkeypatch.setattr(jengine, "quantize_params", port_quantize)
    want = run_reference(load("examples", "serve_batched"), ARGV,
                         monkeypatch)
    port = load("examples_torch", "serve_batched")
    args = port.parse_args(ARGV + ["--device", "cpu"])
    jcfg = JC.get_smoke(args.arch)
    raw = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, raw),
                               device="cpu")
    cfg = port.model_config(args)
    (engine, completions), got = printed(port.run, params, cfg, args,
                                         torch.device("cpu"))
    assert len(got) == len(want) == 6
    assert got[0] == want[0]
    assert "compression 3.41x" in got[0]
    counts, where = _fields(got[1])
    assert counts == _fields(want[1])[0] == ("3", "12", "4")
    assert where == "the CPU" and "this CPU" not in got[1]
    for g, w in zip(got[2:5], want[2:5]):
        assert REQ.fullmatch(g).groups() == REQ.fullmatch(w).groups()
    assert got[5] == want[5]
    assert [len(c.tokens) for c in completions] == [4, 4, 4]


def test_serve_batched_refuses_a_missing_cuda_device(monkeypatch):
    refuses_missing_cuda(load("examples_torch", "serve_batched"),
                         monkeypatch)
