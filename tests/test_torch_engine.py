"""The port's continuous-batching Engine against the JAX Engine (same
config fields, same staggered submissions: identical greedy
completions), the port's import boundary, and its refusal to run on a
missing CUDA device."""
import ast
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro_torch.configs as TC
from repro.models import lm as jlm
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import EngineConfig as JEngineConfig
from repro_torch.convert import params_from_numpy
from repro_torch.models import lm as tlm
from repro_torch.models.sail_linear import QuantPolicy
from repro_torch.models.sail_linear import quantize_params
from repro_torch.serving.engine import Engine as TEngine
from repro_torch.serving.engine import EngineConfig as TEngineConfig
from repro_torch.planning import as_plan

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
ARCH = "tinymistral_248m"
PROMPTS = [[1, 2, 3], [4, 5, 6, 7], [8, 9], [3, 1, 4, 1, 5], [2, 7, 1],
           list(range(20, 40))]


@pytest.fixture(scope="module")
def smoke():
    cfg = JC.get_smoke(ARCH)
    params = jlm.init_params(jax.random.PRNGKey(0), cfg)
    carried = params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                                device="cpu")
    return cfg, TC.get_smoke(ARCH), params, carried


def _serve(engine, staggered=True):
    """Submit three requests, run a few iterations, submit the rest
    mid-decode, drain; returns {uid: tokens}."""
    for p in PROMPTS[:3]:
        engine.submit(p, max_new_tokens=7)
    if staggered:
        for _ in range(3):
            engine.step()
    for p in PROMPTS[3:]:
        engine.submit(p, max_new_tokens=5)
    return {c.uid: c.tokens for c in engine.run()}


@pytest.mark.parametrize("kw", [
    pytest.param(dict(plan="uniform:4"), id="uniform:4"),
    pytest.param(dict(plan="uniform:4a8"), id="uniform:4a8"),
    pytest.param(dict(ql=4, prefill_budget=8, quant_kv=False),
                 id="ql4-budget8-f32kv"),
])
def test_engine_completions_match_reference(smoke, kw):
    jcfg, tcfg, params, carried = smoke
    fields = dict(batch_size=4, cache_len=64, group_size=32,
                  **{"quant_kv": True, **kw})
    ref_engine = JEngine(params, jcfg, JEngineConfig(**fields))
    port_engine = TEngine(carried, tcfg, TEngineConfig(**fields),
                          device="cpu")
    ref, got = _serve(ref_engine), _serve(port_engine)
    assert got == ref
    assert sorted(len(t) for t in got.values()) == [5, 5, 5, 7, 7, 7]
    st, jst = port_engine.stats(), ref_engine.stats()
    for key in ("requests", "generated_tokens", "iterations",
                "prefill_iterations", "decode_iterations", "prefill_tokens",
                "peak_active"):
        assert st[key] == jst[key], key
    assert st["weight_compression"] == jst["weight_compression"]


def test_engine_streams_and_retires_slots(smoke):
    _, tcfg, _, carried = smoke
    eng = TEngine(carried, tcfg, TEngineConfig(batch_size=2, cache_len=64,
                                               group_size=32), device="cpu")
    seen = []
    for p in PROMPTS[:4]:
        eng.submit(p, max_new_tokens=3,
                   on_token=lambda uid, tok: seen.append((uid, tok)))
    done = {c.uid: c.tokens for c in eng.run()}
    assert len(done) == 4 and eng.peak_active == 2
    for uid, toks in done.items():
        assert [t for u, t in seen if u == uid] == toks
    assert eng.sched.idle() and sorted(eng.sched.free_slots) == [0, 1]


def test_plan_grammar_and_unported_options(smoke):
    """What the planning slice ported serves (uniform, rules and per-path
    policies); what waits for later slices raises, naming ROADMAP."""
    _, tcfg, _, carried = smoke
    for spec, bits in (("uniform:4", (4, None)), ("uniform:3a6", (3, 6)),
                       ("rules:mlp=4,default=3a8", (3, 8))):
        plan = as_plan(spec)
        assert (plan.weight_bits, plan.act_bits) == bits
        assert as_plan(plan.format()) == plan
    with pytest.raises(ValueError, match="bits token"):
        as_plan("uniform:x")
    q, _, _ = quantize_params(carried, QuantPolicy(rules=(("mlp", 3),),
                                                   group_size=32,
                                                   min_size=1024))
    assert q["blocks"]["mlp"]["w_up"].bits == 3
    assert q["blocks"]["attn"]["wq"].bits == 4
    eng = TEngine(carried, tcfg, TEngineConfig(
        batch_size=2, cache_len=32, group_size=32, plan="rules:mlp=3"),
        device="cpu")
    assert eng.stats()["mixed_precision"]
    # unsolved plans now solve at construction (the Planner slice)
    for plan in ("auto:q4a8", "uniform:4,kv=auto"):
        eng = TEngine(carried, tcfg, TEngineConfig(
            batch_size=2, cache_len=32, group_size=32, plan=plan),
            device="cpu")
        assert eng.plan.solved and eng.kv_bits in (8, 32)
        assert eng.plan.kv_bits in (8, 32, None)
    for plan in ("uniform:4,draft=q2a8:k4", "uniform:4,tp=2"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            TEngine(carried, tcfg, TEngineConfig(plan=plan), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tlm.prefill(carried, [[1, 2]], dataclasses.replace(tcfg, act="gelu"),
                    8, device="cpu")


def _imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    files += [os.path.join(ROOT, "tools", n) for n in ("lut_gemv_times.py",
                                                       "decode_attn_times.py",
                                                       "typeconv_times.py")]
    for base, _, names in os.walk(os.path.join(ROOT, "src", "repro_torch")):
        files += [os.path.join(base, n) for n in names if n.endswith(".py")]
    return files


def test_port_imports_neither_jax_nor_reference():
    files = _port_files()
    assert len(files) > 20
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, mod)


def test_entry_points_refuse_a_missing_cuda_device(smoke, monkeypatch):
    """Without ``device=`` the entry points ask for CUDA and raise when
    there is none; they never fall back to the CPU on their own."""
    _, tcfg, _, carried = smoke
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    gen = torch.Generator().manual_seed(0)
    prompt = np.zeros((1, 3), np.int64)
    calls = [
        lambda: tlm.init_params(tcfg, gen),
        lambda: tlm.init_cache(tcfg, 2, 16),
        lambda: tlm.prefill(carried, prompt, tcfg, 16),
        lambda: tlm.greedy_generate(carried, prompt, tcfg, 2),
        lambda: TEngine(carried, tcfg, TEngineConfig()),
        lambda: params_from_numpy({"w": np.zeros(3, np.float32)}),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", ARCH, "--smoke"])


def test_serve_launcher_runs_on_cpu(capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--requests",
                "3", "--max-new", "4", "--batch", "2", "--cache-len", "32",
                "--plan", "uniform:4a8"])
    out = capsys.readouterr().out
    assert "Q4a8" in out and "3 requests, 12 tokens" in out
