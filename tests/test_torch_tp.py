"""Tensor-parallel serving in the port against the JAX reference.

Placement rules (``tp_supported``, ``local_config``, ``serving_param_spec``,
``shard_alignment_error``, ``localize_params``) and the wire-8 compressor
are compared in this process.  Everything that needs more than one rank
runs once, in two gloo ranks on the CPU (``tests/_torch_tp_ranks.py``,
spawned with a ``file://`` rendezvous under ``tmp_path``): the all-reduce
at wire 32 and 8, column- and row-parallel LUT-GEMV on integer data, and
the engine at the reference's settings (``tests/test_tp.py``) on the ring
and paged pools.  With one H100 there is no second card to shard over, so
``tp > 1`` is tested here as CPU processes.  The reference's own sharded
tokens come from one JAX process with two host devices, run beside the
ranks."""
import dataclasses
import json
import os
import pickle
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_tp_ranks as ranks
import repro.configs as JC
import repro_torch.configs as TC
from repro.dist import compress as jcompress
from repro.models import lm as jlm
from repro.models import sail_linear as jsl
from repro.serving import distributed as jdist
from repro_torch.dist import compress as tcompress
from repro_torch.models import lm as tlm
from repro_torch.models import sail_linear as tsl
from repro_torch.planning import as_plan, resolve_plan
from repro_torch.serving import distributed as tdist
from repro_torch.serving.engine import Engine as TEngine
from repro_torch.serving.engine import EngineConfig as TEngineConfig

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SRC = os.path.join(ROOT, "src")
ARCH = "tinymistral_248m"
TIMEOUT_S = 240


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's smoke-sized CPU ops are tiny: one intra-op thread runs
    them fastest, and keeps them off the other test workers' cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _env(**extra):
    env = dict(os.environ, **extra)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    return env


# the reference's sharded and unsharded engines: tokens and tp stats
REFERENCE = textwrap.dedent("""
    import json
    import jax
    from repro.configs import get_smoke
    from repro.models import lm
    from repro.serving import engine as E

    quantize, memo = E.quantize_params, {}

    def once(params, policy):
        # one eager quantization per policy: the engines share the trees
        if policy not in memo:
            memo[policy] = quantize(params, policy)
        return memo[policy]

    E.quantize_params = once
    cfg = get_smoke("tinymistral_248m")
    params = lm.init_params(jax.random.PRNGKey(0), cfg)
    PROMPTS = %(prompts)s
    out = {}

    def serve(kw, prompts, max_new):
        eng = E.Engine(params, cfg, E.EngineConfig(**kw))
        for p in prompts:
            eng.submit(list(p), max_new)
        eng.run()
        return eng, [eng.completions[u].tokens for u in sorted(eng.completions)]

    for pool, extra in (("ring", {}), ("paged", {"kv_block_size": 8})):
        out[pool] = serve(dict(%(engine)s, **extra, tp=1, wire=32),
                          PROMPTS, 6)[1]
    out["stats_tp2"] = E.Engine(params, cfg, E.EngineConfig(
        **%(engine)s, tp=2, wire=32)).stats()["tp"]
    for plan in %(plans)s:
        eng, toks = serve(dict(%(wire8)s, plan=plan, tp=1), [%(prompt)s], 5)
        out[plan] = toks
        out[plan + " stats"] = eng.stats()["tp"]
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One JAX process (the reference) and one spawn of two port ranks,
    run side by side: (reference results, [rank 0's, rank 1's])."""
    tmp = tmp_path_factory.mktemp("tp")
    cfg = JC.get_smoke(ARCH)
    raw = jax.tree_util.tree_map(
        np.asarray, jlm.init_params(jax.random.PRNGKey(0), cfg))
    params_path = str(tmp / "params.pkl")
    with open(params_path, "wb") as f:
        pickle.dump(raw, f)
    plans = ["uniform:4a8,tp=2,wire=8", "uniform:4a8",
             "uniform:4,tp=2,wire=8", "uniform:4a8,tp=2,wire=32"]
    code = REFERENCE % dict(prompts=ranks.PROMPTS, engine=ranks.ENGINE,
                            wire8=ranks.WIRE8, prompt=ranks.WIRE8_PROMPT,
                            plans=plans)
    ref = subprocess.Popen(
        [sys.executable, "-c", code], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=_env(
            XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                       + " --xla_force_host_platform_device_count=2"),
            OMP_NUM_THREADS="1"))
    try:
        port = subprocess.run(
            [sys.executable, ranks.__file__, str(tmp), params_path],
            capture_output=True, text=True, env=_env(OMP_NUM_THREADS="1"),
            timeout=TIMEOUT_S)
        out, err = ref.communicate(timeout=TIMEOUT_S)
    finally:
        ref.kill()
    assert port.returncode == 0, port.stderr[-3000:]
    assert ref.returncode == 0, err[-3000:]
    res = []
    for r in range(2):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            res.append(pickle.load(f))
    return json.loads(out.strip().splitlines()[-1]), res


# --- placement rules ------------------------------------------------------------

def _reference_tree(tree):
    """A port tree as the reference's: jnp leaves, quantized leaves as the
    reference's QTensor / StackedQTensor."""
    if isinstance(tree, dict):
        return {k: _reference_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_reference_tree(v) for v in tree)
    if isinstance(tree, (tsl.QTensor, tsl.StackedQTensor)):
        cls = (jsl.QTensor if isinstance(tree, tsl.QTensor)
               else jsl.StackedQTensor)
        return cls(packed=jnp.asarray(tree.packed.numpy().view(np.uint32)),
                   scales=jnp.asarray(tree.scales.numpy()),
                   codebook=jnp.asarray(tree.codebook.numpy()),
                   bits=tree.bits, group_size=tree.group_size, k=tree.k,
                   abits=tree.abits)
    return jnp.asarray(tree.numpy())


def _paths_and_shapes(cfg, group):
    """(keystr path, shape) of every raw leaf of ``cfg``'s tree (shapes
    only, nothing computed) and of the packed / scales / codebook fields a
    4-bit quantization of each matrix would carry."""
    tree = jax.eval_shape(lambda: jlm.init_params(jax.random.PRNGKey(0),
                                                  cfg))
    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        p, shape = jax.tree_util.keystr(path), tuple(leaf.shape)
        out.append((p, shape))
        if len(shape) >= 2:
            *lead, k, n = shape
            out += [(p + ".packed", (*lead, k // group * 4, n)),
                    (p + ".scales", (*lead, k // group, n)),
                    (p + ".codebook", (*lead, 16))]
    return out


@pytest.mark.parametrize("full", [False, True], ids=["smoke", "full"])
def test_placement_rules_match_reference(full):
    jcfg = JC.get_config(ARCH) if full else JC.get_smoke(ARCH)
    tcfg = TC.get_config(ARCH) if full else TC.get_smoke(ARCH)
    paths = _paths_and_shapes(jcfg, 128 if full else 32)
    assert len(paths) > 30
    for path, shape in paths:
        assert tdist.serving_param_spec(path, shape) == tuple(
            jdist.serving_param_spec(path, shape)), path
    variants = [(jcfg, tcfg)] + [
        (dataclasses.replace(jcfg, **kw), dataclasses.replace(tcfg, **kw))
        for kw in (dict(family="moe"), dict(attention_bias=True),
                   dict(mlp_bias=True), dict(n_kv=3), dict(d_ff=jcfg.d_ff + 2))]
    for jc, tc in variants:
        for tp in (1, 2, 3, 4, 8, 16):
            assert tdist.tp_supported(tc, tp) == jdist.tp_supported(jc, tp)
            assert (dataclasses.asdict(tdist.local_config(tc, tp))
                    == dataclasses.asdict(jdist.local_config(jc, tp)))
    assert tdist.local_config(tcfg, 4).head_dim == tcfg.head_dim


@pytest.mark.parametrize("group", [16, 32, 64])
def test_alignment_and_localized_k_match_reference(group):
    cfg = TC.get_smoke(ARCH)
    raw = tlm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    for plan in ("uniform:4", "rules:w_down=3,wo=5a8,default=4"):
        policy = as_plan(plan).to_policy(tsl.QuantPolicy(
            group_size=group, min_size=1024))
        tq, _, _ = tsl.quantize_params(raw, policy)
        jq = _reference_tree(tq)
        for tp in (1, 2, 4):
            assert (tdist.shard_alignment_error(tq, tp)
                    == jdist.shard_alignment_error(jq, tp))
            tk = [(p, leaf.k) for p, leaf in tsl.flatten_with_paths(
                tdist.localize_params(tq, tp)) if hasattr(leaf, "k")]
            jk = [(jax.tree_util.keystr(p), leaf.k)
                  for p, leaf in jax.tree_util.tree_flatten_with_path(
                      jdist.localize_params(jq, tp),
                      is_leaf=lambda x: isinstance(
                          x, (jsl.QTensor, jsl.StackedQTensor)))[0]
                  if hasattr(leaf, "k")]
            assert sorted(tk) == sorted(jk) and len(tk) == 8


def test_slice_params_keeps_whole_groups_and_replicates_the_rest():
    cfg = TC.get_smoke(ARCH)
    raw = tlm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    tq, _, _ = tsl.quantize_params(raw, tsl.QuantPolicy(group_size=32,
                                                        min_size=1024))
    full = dict(tsl.flatten_with_paths(tq))
    for rank in range(2):
        shard = dict(tsl.flatten_with_paths(tdist.slice_params(tq, rank, 2)))
        wo, fwo = shard["['blocks']['attn']['wo']"], \
            full["['blocks']['attn']['wo']"]
        rows = fwo.packed.shape[1] // 2
        assert torch.equal(wo.packed, fwo.packed[:, rank * rows:(rank + 1)
                                                 * rows])
        assert wo.k == fwo.k // 2 and wo.packed.is_contiguous()
        wq, fwq = shard["['blocks']['attn']['wq']"], \
            full["['blocks']['attn']['wq']"]
        n = fwq.n // 2
        assert torch.equal(wq.scales, fwq.scales[..., rank * n:(rank + 1) * n])
        assert wq.k == fwq.k and torch.equal(wq.codebook, fwq.codebook)
        assert shard["['lm_head']"].packed is full["['lm_head']"].packed
        assert shard["['embed']"] is full["['embed']"]
    with pytest.raises(ValueError, match="quant groups"):
        tdist.slice_params(tq, 0, 4)       # wo: 2 groups of 32 on 4 ranks


# --- the wire-8 compressor --------------------------------------------------------

@pytest.mark.parametrize("scale", [0.0, 1e-3, 1.0, 37.5])
def test_quantize_dequantize_bit_equal_to_reference(scale):
    x = (np.random.default_rng(3).standard_normal((4, 3, 64)) * scale).astype(
        np.float32)
    x[0, 0, :4] = [0.5, -0.5, 1.5, -2.5]        # ties round half to even
    if scale:
        x[1, 1, 1] = scale * 3                  # the absmax
    got = tcompress._quantize_dequantize(torch.from_numpy(x)).numpy()
    want = np.asarray(jcompress._quantize_dequantize(jnp.asarray(x)))
    assert got.dtype == want.dtype and np.array_equal(got, want)


# --- two ranks --------------------------------------------------------------------

def test_all_reduce_at_wire_32_and_8(runs):
    _, res = runs
    parts = np.random.default_rng(7).standard_normal((2, 8, 64)).astype(
        np.float32)
    assert np.array_equal(res[0]["wire32"], parts.sum(axis=0))
    want = sum(np.asarray(jcompress._quantize_dequantize(jnp.asarray(p)))
               for p in parts)
    for r in res:
        a, b = r["wire8"]
        assert np.array_equal(a, want) and np.array_equal(a, b)
        assert np.array_equal(r["wire32"], res[0]["wire32"])
    assert np.abs(res[0]["wire8"][0] - parts.sum(axis=0)).max() > 0


def test_sharded_lut_gemv_bit_equal_on_integer_data(runs):
    _, res = runs
    for r in res:
        assert len(r["lut"]) == 15
        for key, cell in r["lut"].items():
            assert cell["scale_one"], key
            assert cell["col"], f"{key}: column-parallel diverged"
            assert cell["row"], f"{key}: row-parallel diverged"
            assert cell["row_k"] == 64, key
            assert cell["int_matches_float"], key


@pytest.mark.parametrize("pool", ["ring", "paged"])
def test_engine_tp2_wire32_tokens_match_tp1(runs, pool):
    ref, res = runs
    for r in res:
        assert r[f"{pool}_tp2"] == r[f"{pool}_tp1"] == ref[pool]
        assert all(len(t) == 6 for t in r[f"{pool}_tp2"])
    # each rank's pool holds its n_kv / 2 heads: [L, B, S, 1, Dh]
    assert res[0]["cache_shape"] == (2, 4, 64, 1, 8)


def test_tp_stats_match_reference(runs):
    ref, res = runs
    want = ref["stats_tp2"]
    for r in res:
        assert r["stats_tp1"] is None
        got = r["stats_tp2"]
        assert (got["shards"], got["wire_bits"]) == (2, 32)
        assert got["allreduce_bytes_per_iter"] == \
            want["allreduce_bytes_per_iter"] == 4096
        for key in ("modeled_t_wire_s", "modeled_wire_share"):
            assert got[key] == pytest.approx(want[key], rel=1e-12, abs=0.0)


def test_plan_tp_and_wire8_tokens_match_reference_tp2(runs):
    """A plan's tp= / wire= override the engine knobs.  At wire 8 the
    reference's tokens part from tp=1 after one token (its int8 partial
    sums), and the port's must be the reference's tp=2 tokens; at wire 32
    the int-activation plan gives tp=1's tokens (its K-sharded inputs
    quantize on the group's absmax)."""
    ref, res = runs
    for r in res:
        for plan in ("uniform:4a8,tp=2,wire=8", "uniform:4,tp=2,wire=8",
                     "uniform:4a8,tp=2,wire=32", "uniform:4a8"):
            assert r[plan] == ref[plan], plan
        st = r["uniform:4a8,tp=2,wire=8 stats"]
        assert (st["shards"], st["wire_bits"]) == (2, 8)
        assert st["allreduce_bytes_per_iter"] == \
            ref["uniform:4a8,tp=2,wire=8 stats"]["allreduce_bytes_per_iter"]
        assert r["uniform:4a8,tp=2,wire=32"] == r["uniform:4a8"]
    assert res[0]["uniform:4a8,tp=2,wire=8"] != res[0]["uniform:4a8"]


def test_controller_decides_alike_on_every_rank(runs):
    """Under an SLO no occupancy meets, the controller sheds and checks
    drift on rank 0's broadcast step times, so both ranks take the same
    decisions (their drift readings too) and serve the same tokens."""
    _, res = runs
    ctl = res[0]["controller"]
    assert ctl == res[1]["controller"]
    assert ctl["checks"] > 0 and ctl["shed"] > 0 and ctl["drift"] is not None
    assert res[0]["controlled"] == res[1]["controlled"]
    assert all(len(t) == 6 for t in res[0]["controlled"])


def test_mismatched_group_raises(runs):
    _, res = runs
    assert "needs a process group of 2 ranks" in res[0]["mismatch"]
    # the reference's gate: no speculative round under TP
    assert "speculative decoding is not supported under tensor-parallel" \
        in res[1]["draft"]
    cfg = TC.get_smoke(ARCH)
    assert "n_kv=2 not divisible by tp=4" in tdist.tp_supported(cfg, 4)
    with pytest.raises(ValueError, match="wire_bits"):
        tdist.TPServing(cfg, 2, wire_bits=16)


def test_unsharded_process_refuses_tp2_plans():
    """A process outside any group serves tp=1 only; resolve_plan passes a
    tp=2 plan through, and the engine refuses it naming the group."""
    cfg = TC.get_smoke(ARCH)
    raw = tlm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert resolve_plan("uniform:4,tp=2", raw, cfg).spec.tp == 2
    with pytest.raises(ValueError, match="needs a process group of 2 ranks"):
        TEngine(raw, cfg, TEngineConfig(batch_size=2, cache_len=32,
                                        group_size=32, tp=2), device="cpu")
    # the reference's gates, before any group is looked at
    with pytest.raises(ValueError, match="ActivationTap cannot coexist"):
        TEngine(raw, cfg, TEngineConfig(batch_size=2, cache_len=32,
                                        group_size=32, tp=2, tap_capacity=8),
                device="cpu")
    with pytest.raises(ValueError, match="wire_bits must be 8 or 32"):
        TEngine(raw, cfg, TEngineConfig(batch_size=2, cache_len=32,
                                        group_size=32, tp=2, wire=16),
                device="cpu")


@pytest.mark.parametrize("device,rank,want", [
    ("cuda:1", 0, "cuda:1"), ("cuda:1", 1, "cuda:0"), ("cuda:1", 2, "cuda:1"),
    ("cuda", 0, "cuda:0"), ("cuda", 3, "cuda:1"), ("cpu", 1, "cpu")])
def test_rank_device_starts_at_the_named_card(monkeypatch, device, rank,
                                              want):
    """The launcher's device per rank: rank 0 on the card the caller
    named (``--device cuda:1`` stays on cuda:1 at tp=1), later ranks
    round robin from there over the cards (two here)."""
    from repro_torch.launch.mesh import rank_device
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert rank_device(rank, device) == torch.device(want)
