"""Self-speculative decoding in the port against the JAX reference, on
tinymistral smoke under the reference tests' BASE policy (bits 8, group 32,
min_size 1024, act_bits 8) with a lossy q3 draft, so that rounds roll back:
``verify_step`` (ring and paged, f32 and int8 KV, on BASE's weights with
f32 activations), ``draft_tokens`` (greedy
and T > 0), the acceptance rule, ``measure_acceptance``, the Planner's
``draft=auto`` solve, and the engine's speculative tokens (greedy and T 0.7,
ring and paged) equal to the reference engine's and, greedy, to the port's
plain engine.  Every input comes from a fixed numpy seed."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro_torch.configs as TC
from repro.core import cost_model as jcm
from repro.models import blocks as jblk
from repro.models import lm as jlm
from repro.models import sail_linear as jsl
from repro.planning import DecodeCostModel as JCost
from repro.planning import Planner as JPlanner
from repro.planning import PlanSpec as JPlanSpec
from repro.serving import engine as jengine
from repro.serving import speculative as jspec
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import EngineConfig as JEngineConfig
from repro_torch.core import cost_model as tcm
from repro_torch.kernels.decode_attn.ops import decode_attention_ring
from repro_torch.models import blocks as tblk
from repro_torch.models import lm as tlm
from repro_torch.models import sail_linear as tsl
from repro_torch.planning import DecodeCostModel as TCost
from repro_torch.planning import DraftSpec as TDraftSpec
from repro_torch.planning import Planner as TPlanner
from repro_torch.serving import speculative as tspec
from repro_torch.serving.engine import Engine as TEngine
from repro_torch.serving.engine import EngineConfig as TEngineConfig

ARCH = "tinymistral_248m"
BASE = dict(bits=8, group_size=32, min_size=1024, act_bits=8)
LOGIT_TOL = dict(rtol=1e-5, atol=1e-4)
# verify's logits are held on BASE's weights with f32 activations: the two
# packages sum in another f32 order, so an 8-bit activation code at a
# rounding tie can go either way and move a row's logits by ~0.05 (it does
# on lane 1 here); the engine tests serve BASE's 8-bit activations end to
# end, and the card holds every int launch to its plain version
VERIFY = dict(BASE, act_bits=None)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's smoke-sized CPU ops are tiny: one intra-op thread runs
    them fastest, and keeps them off the other test workers' cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
PROMPTS = [[1, 2, 3], [4, 5, 6, 7], [8, 9], [3, 1, 4, 1, 5]]
PLAN = "uniform:8a8,draft=q3a8:k3"
ENGINE = dict(batch_size=4, cache_len=64, quantize=True, group_size=32,
              min_size=1024, quant_kv=False, mode="continuous")


def _reference_tree(tree):
    """A port tree as the reference's: jnp leaves, quantized leaves as the
    reference's QTensor / StackedQTensor (int32 words back to uint32)."""
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


@pytest.fixture(scope="module")
def smoke():
    """Seeded smoke weights in both packages, raw and under BASE and the
    q3a8 draft.  The reference quantizes eagerly, seconds a tree at smoke
    size, and the port's quantization is bit-equal to it
    (tests/test_torch_plan.py, test_torch_quant.py), so within this module
    the reference's engines and ``measure_acceptance`` are handed the
    port's trees carried across for these two policies (any other policy
    still goes through the reference's ``quantize_params``)."""
    jcfg, tcfg = JC.get_smoke(ARCH), TC.get_smoke(ARCH)
    carried = tlm.init_params(tcfg, torch.Generator().manual_seed(0),
                              device="cpu")
    raw = _reference_tree(carried)
    made = {}
    for kw in (BASE, dict(BASE, bits=3), VERIFY):
        tq, b0, b1 = tsl.quantize_params(carried, tsl.QuantPolicy(**kw))
        made[jsl.QuantPolicy(**kw)] = (tq, (_reference_tree(tq), b0, b1))
    quantize = jsl.quantize_params

    def carried_across(params, policy=jsl.QuantPolicy()):
        if params is raw and policy in made:
            return made[policy][1]
        return quantize(params, policy)
    trees = {}
    for name, (tq, (jq, _, _)) in zip(("served", "draft", "verify"),
                                      made.values()):
        trees.update({"t" + name: tq, "j" + name: jq})
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jengine, jspec):
            mp.setattr(mod, "quantize_params", carried_across)
        yield dict(jcfg=jcfg, tcfg=tcfg, raw=raw, carried=carried, **trees)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _prefilled(smoke, quant_kv, tree="verify", cache_len=64):
    """Both packages' ring caches (the engines' [4, 64] pool: the
    reference's compiled verify and draft are the engines' too) after a
    prefill of three ragged prompts and a fourth lane at length 1:
    (jcache, tcache, verify tokens [4, 4])."""
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, 256, size=(4, 9))
    lengths = np.array([9, 6, 4, 1], np.int32)
    _, jcache = jlm.prefill(smoke["j" + tree], jnp.asarray(prompt),
                            smoke["jcfg"], cache_len, quant_kv,
                            lengths=jnp.asarray(lengths))
    _, tcache = tlm.prefill(smoke["t" + tree], prompt, smoke["tcfg"],
                            cache_len, quant_kv, lengths=lengths,
                            device="cpu")
    return jcache, tcache, rng.integers(0, 256, size=(4, 4))


def _kv_codes_within_one(tlayers, jlayers, skip=None):
    """The int8 KV codes differ by at most one (a code at a rounding tie
    may go either way: the two packages sum in another f32 order); True
    when they are identical.  ``skip``: a block index left out (the
    paged trash block)."""
    same = True
    for name in ("k", "v"):
        got, ref = _np(tlayers[name]).astype(int), _np(jlayers[name]).astype(int)
        if skip is not None:
            got, ref = np.delete(got, skip, 1), np.delete(ref, skip, 1)
        assert np.abs(got - ref).max() <= 1
        same = same and np.array_equal(got, ref)
    return same


@pytest.mark.parametrize("quant_kv", [False, True], ids=["f32kv", "int8kv"])
def test_verify_step_matches_reference_ring(smoke, quant_kv):
    """Four tokens per lane at positions length + t on the ring, lane 3
    masked: logits [B, T, V] and the whole cache against the reference's
    (with int8 KV the codes within one and the logits held where they are
    equal), and each row equal to the port's own decode steps fed the
    same tokens one at a time."""
    jcache, tcache, toks = _prefilled(smoke, quant_kv)
    mask = np.array([True, True, True, False])
    jl, jc = jlm.verify_step(smoke["jverify"], jnp.asarray(toks), jcache,
                             smoke["jcfg"], quant_kv=quant_kv,
                             active_mask=jnp.asarray(mask))
    steps = {"length": tcache["length"].clone(),
             "layers": {n: a.clone() for n, a in tcache["layers"].items()}}
    tl, tc = tlm.verify_step(smoke["tverify"], toks, tcache, smoke["tcfg"],
                             quant_kv=quant_kv, active_mask=mask,
                             device="cpu")
    assert tl.shape == (4, 4, 256)
    np.testing.assert_array_equal(tc["length"].numpy(),
                                  np.asarray(jc["length"]))
    np.testing.assert_array_equal(tc["length"].numpy(), [13, 10, 8, 1])
    if not quant_kv or _kv_codes_within_one(tc["layers"], jc["layers"]):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
        for name, a in tc["layers"].items():
            np.testing.assert_allclose(a.numpy().astype(np.float32),
                                       np.asarray(jc["layers"][name],
                                                  np.float32), **LOGIT_TOL)
    # verify is the decode step T times over, token by token
    for t in range(4):
        dl, steps = tlm.decode_step(smoke["tverify"], toks[:, t:t + 1],
                                    steps, smoke["tcfg"], quant_kv,
                                    active_mask=mask, device="cpu")
        np.testing.assert_allclose(tl[mask, t].numpy(), dl[mask].numpy(),
                                   rtol=1e-6, atol=1e-6)


def _paged_from_ring(cache, jnp_out=False):
    """Lay a ring cache [L, 4, 32, ...] out as a pool of 8-row blocks:
    lane b's logical block j in physical block TABLES[b, j]; lane 3's
    table is all trash (block 16)."""
    out = {}
    for name, a in cache["layers"].items():
        a = _np(a)
        pool = np.zeros((a.shape[0], 17, 8) + a.shape[3:], a.dtype)
        for b in range(3):
            for j in range(4):
                pool[:, TABLES[b, j]] = a[:, b, 8 * j:8 * j + 8]
        out[name] = jnp.asarray(pool) if jnp_out else torch.from_numpy(pool)
    length = _np(cache["length"])
    return {"length": (jnp.asarray(length) if jnp_out
                       else torch.from_numpy(length.copy())),
            "layers": out}


TABLES = np.array([[3, 7, 0, 12], [5, 1, 14, 9], [2, 11, 6, 15],
                   [16, 16, 16, 16]], np.int32)


@pytest.mark.parametrize("quant_kv", [False, True], ids=["f32kv", "int8kv"])
def test_verify_step_matches_reference_paged(smoke, quant_kv):
    """The same verify over a paged pool read and written through
    scrambled block tables (lane 3 masked onto the trash block): logits
    and every live block against the reference's, and the logits equal to
    the ring verify's."""
    jcache, tcache, toks = _prefilled(smoke, quant_kv, cache_len=32)
    mask = np.array([True, True, True, False])
    jpool, tpool = _paged_from_ring(jcache, True), _paged_from_ring(tcache)
    jl, jc = jlm.verify_step(smoke["jverify"], jnp.asarray(toks), jpool,
                             smoke["jcfg"], quant_kv=quant_kv,
                             active_mask=jnp.asarray(mask),
                             block_tables=jnp.asarray(TABLES))
    tl, tc = tlm.verify_step(smoke["tverify"], toks, tpool, smoke["tcfg"],
                             quant_kv=quant_kv, active_mask=mask,
                             device="cpu",
                             block_tables=torch.from_numpy(TABLES))
    np.testing.assert_array_equal(tc["length"].numpy(),
                                  np.asarray(jc["length"]))
    if not quant_kv or _kv_codes_within_one(tc["layers"], jc["layers"],
                                            skip=16):
        np.testing.assert_allclose(tl[mask].numpy(), np.asarray(jl)[mask],
                                   **LOGIT_TOL)
        for name, a in tc["layers"].items():
            np.testing.assert_allclose(
                np.delete(a.numpy().astype(np.float32), 16, 1),
                np.delete(np.asarray(jc["layers"][name], np.float32), 16, 1),
                **LOGIT_TOL)
    rl, _ = tlm.verify_step(smoke["tverify"], toks, tcache, smoke["tcfg"],
                            quant_kv=quant_kv, active_mask=mask,
                            device="cpu")
    np.testing.assert_array_equal(tl[mask].numpy(), rl[mask].numpy())


def test_verify_attention_is_the_chunk_causal_composite(smoke):
    """Verify's per-token decode attention against the reference's
    chunk-causal composite (``blocks._verify_attend``, plain PyTorch) on
    a ring whose T newest slots were just written, lanes at several
    positions and a window shorter than the ring."""
    rng = np.random.default_rng(2)
    b, s, kv, g, d, t = 3, 32, 2, 4, 16, 4
    q = torch.from_numpy(rng.standard_normal((b, t, kv * g, d))
                         .astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((b, s, kv, d)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((b, s, kv, d)).astype(np.float32))
    position = torch.tensor([0, 9, 27], dtype=torch.int32)
    for window in (None, 6):
        cfg = dataclasses.replace(smoke["tcfg"], window=window)
        want = tblk._verify_attend(q, k, v, position, cfg, s)
        got = torch.stack([decode_attention_ring(
            q[:, j].contiguous(), k, v, position + j, window or s)
            for j in range(t)], 1)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-6)
        jcfg = dataclasses.replace(smoke["jcfg"], window=window)
        jwant = jblk._verify_attend(
            jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
            jnp.asarray(v.numpy()), jnp.asarray(position.numpy()), jcfg, s)
        np.testing.assert_allclose(want.numpy(), np.asarray(jwant),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_draft_tokens_match_reference(smoke, temperature):
    """k = 3 draft steps under the q3a8 tree: the same drafts and draft
    logits as the reference's, greedy and on the DRAFT_SALT key stream."""
    jcache, tcache, _ = _prefilled(smoke, False, tree="draft")
    mask = np.array([True, True, True, False])
    cur = np.array([[7], [200], [31], [0]])
    uids = np.array([3, 1, 70000, 0], np.int64)
    idx = np.array([4, 0, 9, 0], np.int64)
    # the engines' seeds (greedy: the default 0), so the reference's
    # compiled draft is the engines' too
    seed = 7 if temperature > 0 else 0
    jd, jq, jc = jlm.draft_tokens(
        smoke["jdraft"], jnp.asarray(cur), jcache, smoke["jcfg"], 3,
        active_mask=jnp.asarray(mask), temperature=temperature, seed=seed,
        uids=jnp.asarray(uids.astype(np.uint32)),
        indices=jnp.asarray(idx.astype(np.uint32)))
    td, tq, tc = tlm.draft_tokens(
        smoke["tdraft"], cur, tcache, smoke["tcfg"], 3, active_mask=mask,
        device="cpu", temperature=temperature, seed=seed, uids=uids,
        indices=idx)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), **LOGIT_TOL)
    np.testing.assert_array_equal(tc["length"].numpy(),
                                  np.asarray(jc["length"]))
    assert tlm.DRAFT_SALT == jlm.DRAFT_SALT


def _accept_inputs(seed, b=4, k=3, v=64):
    """Verify logits and draft logits that disagree often enough to reject
    somewhere, and drafts drawn near the draft's argmax."""
    rng = np.random.default_rng(seed)
    vl = (rng.standard_normal((b, k + 1, v)) * 2).astype(np.float32)
    dl = (vl[:, :k] + rng.standard_normal((b, k, v)) * 1.5).astype(np.float32)
    draft = np.argmax(dl, -1)
    return draft, vl, dl


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("temperature", [0.0, 0.7, 1.3])
def test_accept_matches_reference(seed, temperature):
    """The acceptance rule on the same inputs: equal accepted prefixes and
    next tokens, greedy and stochastic (salted uniforms bit-equal)."""
    draft, vl, dl = _accept_inputs(seed)
    uids = np.array([5, 9, 0, 70000])
    idx = np.array([0, 3, 17, 65536])
    kw = dict(temperature=temperature, seed=seed + 11, uids=uids,
              indices=idx)
    want = jspec.SpeculativeDecoder.accept(
        object.__new__(jspec.SpeculativeDecoder), draft, vl, dl, **kw)
    got = tspec.SpeculativeDecoder.accept(
        object.__new__(tspec.SpeculativeDecoder), draft, vl, dl, **kw)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    for salt in (tlm.ACCEPT_SALT, tlm.RESAMPLE_SALT, tlm.BONUS_SALT):
        assert tspec._stream_uniform(seed, 9, 3, salt) == \
            jspec._stream_uniform(seed, 9, 3, salt)


def test_accept_rejects_and_accepts_somewhere():
    """The inputs above exercise both branches of the rule."""
    n_acc = np.concatenate([tspec.SpeculativeDecoder.accept(
        object.__new__(tspec.SpeculativeDecoder), *_accept_inputs(s),
        temperature=0.7, seed=1, uids=np.arange(4), indices=np.zeros(4))[0]
        for s in range(3)])
    assert n_acc.min() < 3 and n_acc.max() > 0


@pytest.mark.parametrize("bits", [3, 8])
def test_measure_acceptance_matches_reference(smoke, bits):
    """Teacher-forced agreement of a q3 draft (lossy) and a q8 draft (the
    served tree itself: exactly 1.0) with the served tree, as the
    reference measures it."""
    kw = dict(act_bits=8, prompt=[1, 2, 3, 5], n_tokens=8)
    want = jspec.measure_acceptance(smoke["raw"], smoke["jcfg"],
                                    jsl.QuantPolicy(**BASE), bits, **kw)
    got = tspec.measure_acceptance(smoke["carried"], smoke["tcfg"],
                                   tsl.QuantPolicy(**BASE), bits, **kw)
    assert got == want
    assert got == 1.0 if bits == 8 else 0.0 <= got <= 1.0


def _seeded_planners(smoke, jcost=None, tcost=None):
    j = JPlanner(smoke["raw"], smoke["jcfg"], "uniform:8a8,draft=auto",
                 base=jsl.QuantPolicy(**BASE), cost=jcost)
    t = TPlanner(smoke["carried"], smoke["tcfg"], "uniform:8a8,draft=auto",
                 base=tsl.QuantPolicy(**BASE), cost=tcost)
    # the reference test's acceptance curve, so the grid solve runs
    # without the probes
    for p in (j, t):
        for bits, acc in ((2, 0.35), (3, 0.6), (4, 0.9)):
            p._draft_acceptance[(bits, 8)] = acc
    return j, t


def test_draft_auto_solve_matches_reference(smoke):
    """The (draft bits, k) grid solve: no draft on the compute-bound
    default machine, the reference's DraftSpec (with its acceptance) on a
    DRAM-bound one, and the same spec hash."""
    j, t = _seeded_planners(smoke)
    assert t.solve().spec.draft is None and j.solve().spec.draft is None
    j, t = _seeded_planners(
        smoke, JCost(machine=jcm.SailMachine(dram_bw=2.0e9), batch=1),
        TCost(machine=tcm.SailMachine(dram_bw=2.0e9), batch=1))
    jr, tr = j.solve(), t.solve()
    d = tr.spec.draft
    assert isinstance(d, TDraftSpec) and tr.spec.solved
    assert d.to_json() == jr.spec.draft.to_json()
    assert tr.spec.spec_hash == jr.spec.spec_hash
    assert d.acceptance == t._draft_acceptance[(d.weight_bits, 8)]


def test_draft_auto_measures_acceptance_at_construction(smoke, monkeypatch):
    """An engine given draft=auto asks ``measure_acceptance`` (held to the
    reference's above) once per grid bit width, on the 32-token
    calibration prompt, and serves the solve's pick: no draft on the
    default compute-bound machine, the reference's draftless plan.  The
    probes run on the prompt's first 4 tokens and 4 continuation tokens
    here (the full probe is 130 decode passes a bit width on the CPU)."""
    probes = []
    measure = tspec.measure_acceptance

    def spy(raw, cfg, policy, bits, act_bits=None, prompt=None, **kw):
        probes.append((bits, act_bits, len(prompt)))
        return measure(raw, cfg, policy, bits, act_bits=act_bits,
                       prompt=prompt[:4], n_tokens=4)
    monkeypatch.setattr(tspec, "measure_acceptance", spy)
    eng = TEngine(smoke["carried"], smoke["tcfg"], TEngineConfig(
        **ENGINE, plan="uniform:8a8,draft=auto"), device="cpu")
    assert probes == [(2, 8, 32), (3, 8, 32), (4, 8, 32)]
    assert eng.plan.solved and eng.plan.draft is None
    assert eng.plan.spec_hash == JPlanSpec.parse("uniform:8a8").spec_hash
    assert eng.spec_decoder is None and eng.stats()["speculative"] is None


# --- the engine ---------------------------------------------------------------

def _serve(engine, max_new=8):
    for p in PROMPTS:
        engine.submit(p, max_new_tokens=max_new)
    return {c.uid: c.tokens for c in engine.run()}


@pytest.fixture(scope="module")
def ref_runs(smoke):
    """The reference's speculative engine on the ring, greedy and at T
    0.7 (its own tests hold the ring equal to the paged pool)."""
    runs = {}
    for name, kw in (("greedy", {}), ("sampled", dict(temperature=0.7,
                                                      seed=7))):
        eng = JEngine(smoke["raw"], smoke["jcfg"],
                      JEngineConfig(**ENGINE, plan=PLAN, **kw))
        runs[name] = (_serve(eng), eng.stats())
    return runs


def _tengine(smoke, plan=PLAN, **kw):
    return TEngine(smoke["carried"], smoke["tcfg"],
                   TEngineConfig(**{**ENGINE, "plan": plan, **kw}),
                   device="cpu")


@pytest.mark.parametrize("pool", ["ring", "paged"])
def test_greedy_speculation_matches_reference_and_plain(smoke, ref_runs,
                                                         pool):
    """Greedy rounds with rejections: the reference speculative engine's
    tokens and the port's plain engine's, the same round statistics as the
    reference's, and on the paged pool truncated tables and a clean
    drain."""
    kw = dict(kv_block_size=8) if pool == "paged" else {}
    eng = _tengine(smoke, **kw)
    got = _serve(eng)
    want, jst = ref_runs["greedy"]
    assert got == want
    assert got == _serve(_tengine(smoke, plan="uniform:8a8", **kw))
    st = eng.stats()["speculative"]
    assert st == jst["speculative"]
    assert 0 < st["accepted"] < st["drafted"]
    assert eng.iterations < sum(len(t) for t in got.values())
    if pool == "paged":
        eng.block_mgr.check_invariants()
        assert eng.stats()["block_pool"]["used_blocks"] == 0


@pytest.mark.parametrize("pool", ["ring", "paged"])
def test_sampled_speculation_matches_reference(smoke, ref_runs, pool):
    """At T 0.7 (seed 7): the p/q coin flips and resamples on the salted
    streams give the reference engine's tokens, on either pool."""
    kw = dict(kv_block_size=8) if pool == "paged" else {}
    eng = _tengine(smoke, temperature=0.7, seed=7, **kw)
    want, jst = ref_runs["sampled"]
    assert _serve(eng) == want
    assert eng.stats()["speculative"] == jst["speculative"]


def test_paged_rollback_truncates_tables(smoke):
    """Blocks of 4 tokens and k 3: a round's grant reaches into a block
    that a rejection gives back (``truncate`` cuts the table to the
    accepted frontier, and its tail goes back to the trash block)."""
    eng = _tengine(smoke, kv_block_size=4)
    calls = []
    truncate = eng.block_mgr.truncate

    def spy(uid, n):
        dropped = truncate(uid, n)
        calls.append(dropped)
        assert len(eng.block_mgr.table(uid)) == -(-n // 4)
        return dropped
    eng.block_mgr.truncate = spy
    _serve(eng)
    assert sum(calls) > 0
    assert (eng._tables_np == eng._trash).all()


def test_int_draft_and_int8_kv_serve(smoke):
    """A uniform:4 plan under a q2a8 draft with int8 KV: token-identical
    to plain greedy decoding on either pool."""
    plain = _serve(_tengine(smoke, plan="uniform:4", quant_kv=True), 4)
    for kw in ({}, dict(kv_block_size=8)):
        eng = _tengine(smoke, plan="uniform:4,draft=q2a8:k4", quant_kv=True,
                       **kw)
        assert _serve(eng, 4) == plain
        assert eng.spec_decoder.draft_params["lm_head"].abits == 8


def test_gates_and_lookahead_guard(smoke):
    """The reference's refusals: batch mode, a tap, a recurrent family,
    sinusoidal positions; ``submit`` reserves the k + 1 lookahead on the
    ring and on a paged lane."""
    tcfg, carried = smoke["tcfg"], smoke["carried"]
    with pytest.raises(ValueError, match="continuous"):
        TEngine(carried, tcfg, TEngineConfig(**dict(ENGINE, mode="batch"),
                                             plan=PLAN), device="cpu")
    with pytest.raises(ValueError, match="ActivationTap"):
        _tengine(smoke, tap_capacity=16)
    for field, value, match in (("family", "ssm", "attention"),
                                ("pos", "sinusoidal", "sinusoidal")):
        with pytest.raises(ValueError, match=match):
            TEngine(carried, dataclasses.replace(tcfg, **{field: value}),
                    TEngineConfig(**ENGINE, plan=PLAN), device="cpu")
    eng = _tengine(smoke)
    with pytest.raises(ValueError, match="ring holds"):
        eng.submit([1] * 10, max_new_tokens=51)
    assert eng.submit([1] * 10, max_new_tokens=50) > 0
    assert _tengine(smoke, plan="uniform:8a8").submit([1] * 10, 54) > 0
    paged = _tengine(smoke, kv_block_size=8)
    with pytest.raises(ValueError, match="paged lane"):
        paged.submit([1] * 10, max_new_tokens=51)


def test_apply_plan_swaps_the_draft(smoke):
    """``apply_plan`` mid-serve: a new draft requantizes the draft tree,
    a draftless plan stops speculating, and the tokens stay plain
    greedy decoding's."""
    plain = _serve(_tengine(smoke, plan="uniform:8a8"), max_new=10)
    eng = _tengine(smoke, retain_raw=True)
    for p in PROMPTS:
        eng.submit(p, max_new_tokens=10)
    for _ in range(3):
        eng.step()
    eng.apply_plan("uniform:8a8,draft=q2:k2")
    assert eng.spec_decoder.k == 2 and eng.spec_decoder.policy.bits == 2
    for _ in range(2):
        eng.step()
    eng.apply_plan("uniform:8a8")
    assert eng.spec_decoder is None and eng.stats()["speculative"] is None
    eng.run()
    assert {c.uid: c.tokens for c in eng.completions.values()} == plain


def test_controller_prices_rounds(smoke, ref_runs):
    """A speculating engine's controller budgets per round (E[accepted +
    1] tokens per lane), as the reference's: the same tokens per round,
    feasibility at every occupancy and cap under an SLO the plain plan
    cannot meet at the full pool; the controlled tokens stay greedy's."""
    import warnings
    slo = _tengine(smoke, plan="uniform:8a8").planned_tps() * 1.2
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jeng = JEngine(smoke["raw"], smoke["jcfg"], JEngineConfig(
            **ENGINE, plan=PLAN, slo=slo, controller=True))
        teng = _tengine(smoke, slo=slo, controller=True)
    tc, jc = teng.controller, jeng.controller
    assert tc.tokens_per_iter == jc.tokens_per_iter
    assert teng.planned_tps() == pytest.approx(jeng.planned_tps(), rel=1e-12)
    assert [tc.meets_slo_at(b) for b in range(1, 5)] == \
        [jc.meets_slo_at(b) for b in range(1, 5)]
    assert tc.batch_cap(4) == jc.batch_cap(4)
    assert _serve(teng) == ref_runs["greedy"][0]
    assert teng.stats()["controller"]["batch_cap"] == jc.batch_cap(4)
