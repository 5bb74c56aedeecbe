"""The port's paged KV pool against the JAX reference on tinymistral
smoke: the block-space manager driven through the same op sequences (every
return value, table and stat equal), the plain table-mode attention
against the reference's gather + ``_decode_attend``, the paged decode step,
and the paged engine (greedy-token-identical to the reference's paged
engine and to the port's ring engine: plain, with prefix sharing, under
preemption).  Every input comes from a fixed numpy seed."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro_torch.configs as TC
from repro.core.scheduler import IterationScheduler as JScheduler
from repro.core.scheduler import Request as JRequest
from repro.models import blocks as jblocks
from repro.models import lm as jlm
from repro.models.common import ModelConfig as JModelConfig
from repro.models.sail_linear import QuantPolicy as JPolicy
from repro.models.sail_linear import quantize_params as jquantize
from repro.planning import cost as jcost
from repro.serving.block_pool import BlockSpaceManager as JManager
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import EngineConfig as JEngineConfig
from repro_torch.convert import params_from_numpy
from repro_torch.core import quant as tq
from repro_torch.core.scheduler import IterationScheduler as TScheduler
from repro_torch.core.scheduler import Request as TRequest
from repro_torch.kernels import _build
from repro_torch.kernels.decode_attn import kernel as tda_kernel
from repro_torch.kernels.decode_attn import ops as tda_ops
from repro_torch.kernels.decode_attn import ref as tda_ref
from repro_torch.models import lm as tlm
from repro_torch.planning import cost as tcost
from repro_torch.serving.block_pool import BlockSpaceManager as TManager
from repro_torch.serving.engine import Engine as TEngine
from repro_torch.serving.engine import EngineConfig as TEngineConfig

ARCH = "tinymistral_248m"
ATTN_TOL = dict(rtol=2e-5, atol=2e-5)      # tests/test_kernels.py's
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)     # tests/test_torch_model.py's


# --- the block-space manager, op for op ------------------------------------

def _apply(mgr, op):
    """One op on a manager: ("ok", result) or ("raises", exception type)."""
    name, *args = op
    try:
        return "ok", getattr(mgr, name)(*args)
    except (KeyError, ValueError, MemoryError) as e:
        return "raises", type(e).__name__


def _state(mgr):
    uids = sorted(mgr._tables)
    return ({u: (mgr.table(u), mgr.shared_prefix_blocks(u)) for u in uids},
            mgr.stats(), mgr.free_blocks, mgr.used_blocks)


def _drive(ops, num_blocks, block_size, share_prefix=True):
    """The same ops on the reference's manager and the port's: every result
    and the state after every op are equal, and both keep their
    invariants."""
    ref = JManager(num_blocks, block_size, share_prefix=share_prefix)
    port = TManager(num_blocks, block_size, share_prefix=share_prefix)
    results = []
    for op in ops:
        got, want = _apply(port, op), _apply(ref, op)
        assert got == want, op
        assert _state(port) == _state(ref), op
        port.check_invariants()
        ref.check_invariants()
        results.append(got)
    return results


def _soup(seed):
    """A seeded mix of allocate / append / preempt / free / truncate and
    the two admission queries, over prompts drawn from three shared stems
    (so prefixes are shared, copied on write and preempted), with some
    ops that must raise (a uid twice, an unknown uid, a skipped
    position)."""
    rng = np.random.default_rng(seed)
    num_blocks = int(rng.integers(3, 17))
    block_size = int(rng.choice([1, 2, 3, 4, 8]))
    stems = [tuple(int(t) for t in rng.integers(1, 6, 12)) for _ in range(3)]
    prompt = lambda: stems[rng.integers(3)][:int(rng.integers(1, 13))] + \
        tuple(int(t) for t in rng.integers(1, 6, int(rng.integers(0, 3))))
    ops, live, next_uid = [], {}, 0
    for _ in range(60):
        kind = int(rng.integers(9))
        uid = (sorted(live)[int(rng.integers(len(live)))] if live
               else next_uid)
        if kind <= 1 or not live:
            p = prompt()
            ops.append(("allocate", next_uid, p))
            live[next_uid] = len(p)
            next_uid += 1
        elif kind <= 4:
            skip = int(rng.integers(8)) == 0
            ops.append(("append_slot", uid, live[uid] + (block_size * 3
                                                          if skip else 0)))
            if not skip:
                live[uid] += 1
        elif kind == 5:
            ops.append(("preempt", uid))
            live.pop(uid)
        elif kind == 6:
            ops.append(("free", uid if rng.integers(6) else 999))
            live.pop(uid, None)
        elif kind == 7:
            n = int(rng.integers(0, live[uid] + 1))
            ops.append(("truncate", uid, n))
            live[uid] = n
        else:
            ops.append(("admission_cap", [prompt() for _ in range(3)]))
            ops.append(("can_allocate", prompt()))
        if rng.integers(10) == 0:
            ops.append(("allocate", uid, prompt()))      # may repeat a uid
    ops += [("free", u) for u in sorted(live)]
    return ops, num_blocks, block_size, bool(rng.integers(4))


@pytest.mark.parametrize("seed", range(40))
def test_block_manager_matches_reference_on_op_soups(seed):
    """Forty seeded soups (3-16 blocks of 1-8 tokens, sharing on or off):
    equal results, tables, stats and invariants after every op."""
    ops, num_blocks, block_size, share = _soup(seed)
    _drive(ops, num_blocks, block_size, share)


# The reference's own scenarios (tests/test_block_pool.py), as op lists.
P6 = (1, 2, 3, 4, 5, 6)
P8 = (1, 2, 3, 4, 5, 6, 7, 8)
SCENARIOS = {
    "round_trip": (8, 4, [("allocate", 1, (1, 2, 3, 4, 5)), ("free", 1)]),
    "duplicate_uid_and_double_free": (4, 4, [
        ("allocate", 1, (1, 2)), ("allocate", 1, (1, 2)), ("free", 1),
        ("free", 1)]),
    "prefix_sharing": (8, 4, [("allocate", 1, P6), ("allocate", 2, P6),
                              ("free", 1), ("free", 2)]),
    "divergent_prompts": (16, 4, [("allocate", 1, (1, 2, 3, 4, 9, 9)),
                                  ("allocate", 2, (1, 2, 3, 4, 7, 7))]),
    "append_inplace_alloc_cow": (8, 4, [
        ("allocate", 1, P6), ("allocate", 2, P6), ("append_slot", 1, 6),
        ("append_slot", 2, 6), ("append_slot", 1, 8), ("free", 1),
        ("free", 2)]),
    "append_oom_then_preempt": (2, 4, [("allocate", 1, P8),
                                       ("append_slot", 1, 8),
                                       ("preempt", 1)]),
    "truncate_tail_and_regrow": (8, 4, [
        ("allocate", 1, tuple(range(1, 11))), ("truncate", 1, 10),
        ("truncate", 1, 5), ("append_slot", 1, 8)]),
    "truncate_shared_tail": (8, 4, [("allocate", 1, P8), ("allocate", 2, P8),
                                    ("truncate", 2, 4), ("free", 1),
                                    ("free", 2)]),
    "truncate_to_zero": (4, 4, [("allocate", 7, (1, 2, 3, 4, 5)),
                                ("truncate", 7, 0)]),
    "admission_cap": (5, 4, [
        ("admission_cap", [(1, 2, 3, 4, 5)] * 3),
        ("allocate", 0, (1, 2, 3, 4, 5)),
        ("admission_cap", [(1, 2, 3, 4, 5)] * 2),
        ("can_allocate", (1, 2, 3, 4, 5)), ("allocate", 1, (1, 2, 3, 4, 5)),
        ("allocate", 2, (1, 2, 3, 4, 5))]),
    "no_sharing_when_off": (8, 4, [("allocate", 1, P6),
                                   ("allocate", 2, P6)]),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_block_manager_matches_reference_scenarios(name):
    num_blocks, block_size, ops = SCENARIOS[name]
    results = _drive(ops, num_blocks, block_size,
                     share_prefix=name != "no_sharing_when_off")
    if name == "append_inplace_alloc_cow":
        kinds = [r[1][0] for r in results[2:5]]
        assert kinds == ["cow", "inplace", "alloc"]
    if name == "duplicate_uid_and_double_free":
        assert results[1] == results[3] == ("raises", "KeyError")


def test_scheduler_gate_and_preempt_match_reference():
    """``schedule(can_admit=...)`` stops at the first refusal (FIFO holds)
    and ``preempt`` requeues at the front with its slot freed, as the
    reference scheduler does."""
    out = []
    for sched_cls, req_cls in ((JScheduler, JRequest),
                               (TScheduler, TRequest)):
        s = sched_cls(target_batch=3, max_batch=3)
        for uid in range(1, 6):
            s.submit(req_cls(uid=uid, prompt_len=uid, max_new_tokens=2))
        first = [r.uid for r in s.schedule(can_admit=lambda r: r.uid != 3)]
        s.preempt(2)
        second = [r.uid for r in s.schedule(can_admit=lambda r: True)]
        with pytest.raises(KeyError):
            s.preempt(99)
        out.append((first, second, [r.uid for r in s.waiting],
                    [(r.uid, r.slot) for r in s.running], s.free_slots))
    assert out[0] == out[1]
    assert out[1][0] == [1, 2] and out[1][1] == [2, 3]


def test_kv_pool_pricing_matches_reference():
    for args in ((12, 8, 32), (2, 2, 8), (30, 4, 128)):
        for bits in (8, 32):
            assert tcost.kv_token_bytes(*args, bits) == \
                jcost.kv_token_bytes(*args, bits)
            for bs in (1, 8, 16):
                assert tcost.kv_block_bytes(bs, *args, bits) == \
                    jcost.kv_block_bytes(bs, *args, bits)
                for budget in (0, 1 << 20, 123456789):
                    assert tcost.kv_pool_blocks(budget, bs, *args, bits) == \
                        jcost.kv_pool_blocks(budget, bs, *args, bits)
    with pytest.raises(ValueError):
        tcost.kv_token_bytes(2, 2, 8, 16)


# --- table-mode attention ----------------------------------------------------

def _paged_inputs(seed, quantized, b=4, kv=2, g=4, d=16, bs=8, mbs=6,
                  nb=30):
    """A pool of nb blocks plus a trash block (index nb), and b lanes'
    tables: shuffled blocks with gaps in between, and one lane (the last)
    whose entries are all trash, at a frozen position."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, kv * g, d)).astype(np.float32)
    k = rng.standard_normal((nb + 1, bs, kv, d)).astype(np.float32)
    v = rng.standard_normal((nb + 1, bs, kv, d)).astype(np.float32)
    perm = rng.permutation(nb)
    tables = np.full((b, mbs), nb, np.int32)
    position = np.array([0, bs + 3, mbs * bs - 1, 13][:b], np.int32)
    for i in range(b - 1):
        used = position[i] // bs + 1
        tables[i, :used] = perm[i * mbs:i * mbs + used]
    t = lambda a: torch.from_numpy(a)
    if quantized:
        (kq, ks), (vq, vs) = tq.quantize_kv(t(k)), tq.quantize_kv(t(v))
        return q, (kq, vq, ks, vs), tables, position
    return q, (t(k), t(v), None, None), tables, position


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("window", [None, 20])
def test_paged_attention_matches_reference_gather(quantized, window):
    """The plain table mode against the reference's paged decode step: its
    gather of each lane's blocks into a contiguous view, then
    ``_decode_attend`` with ring validity over mbs * BS slots."""
    q, (k, v, ks, vs), tables, position = _paged_inputs(
        7 + int(quantized), quantized)
    b, h, d = q.shape
    mbs, bs, kv = tables.shape[1], k.shape[1], k.shape[2]
    s = mbs * bs
    got = tda_ops.decode_attention_paged(
        torch.from_numpy(q), k, v, torch.from_numpy(position),
        torch.from_numpy(tables), window or s, ks, vs)
    kf = k.float() * ks if quantized else k
    vf = v.float() * vs if quantized else v
    gather = lambda pool: jnp.asarray(pool.numpy())[jnp.asarray(tables)] \
        .reshape((b, s, kv, d))
    cfg = JModelConfig(d_model=h * d, n_heads=h, n_kv=kv, window=window)
    ref = jblocks._decode_attend(jnp.asarray(q)[:, None], gather(kf),
                                 gather(vf), jnp.asarray(position), cfg, s)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref)[:, 0],
                               **ATTN_TOL)


def test_paged_attention_equals_ring_on_the_same_rows():
    """Table mode over a pool equals ring mode over the rows laid out
    contiguously (the layout is all that differs), and a table entry
    outside the pool is refused."""
    q, (k, v, ks, vs), tables, position = _paged_inputs(3, True)
    t = torch.from_numpy
    got = tda_ops.decode_attention_paged(t(q), k, v, t(position), t(tables),
                                         40, ks, vs)
    g = lambda a: tda_ref.gather_blocks(a, t(tables))
    ring = tda_ops.decode_attention_ring(t(q), g(k), g(v), t(position), 40,
                                         g(ks), g(vs))
    assert torch.equal(got, ring)
    bad = tables.copy()
    bad[0, 0] = k.shape[0]
    with pytest.raises(ValueError, match="block table"):
        tda_ops.decode_attention_paged(t(q), k, v, t(position), t(bad), 40,
                                       ks, vs)


@pytest.mark.parametrize("bs", [1, 3, 8, 12, 16])
def test_table_row_matches_the_gather(bs):
    """The kernel's slot -> pool row map, written out (a multiply-high for
    slot / BS, one compare), against the reference's gather index, for
    every slot of a shuffled table, and for slots up to 2^30."""
    rng = np.random.default_rng(bs)
    mbs = 64 // bs + 3
    table = rng.permutation(4 * mbs)[:mbs]
    for slot in range(mbs * bs):
        assert tda_kernel.table_row(table, slot, bs) == \
            table[slot // bs] * bs + slot % bs

    class Identity:
        def __getitem__(self, i):
            return i

    for slot in [*rng.integers(0, 1 << 30, 2000), (1 << 30) - 1, bs - 1, bs]:
        assert tda_kernel.table_row(Identity(), int(slot), bs) == int(slot)


# (case, q shape, pool shape, table (dtype, shape, contiguous, device),
# scale shape, window, ring, message); shapes: B 2, KV 2, G 4, D 32,
# pool [NB 5, BS 8], tables [2, 3]
REFUSALS = [
    ("accepted", (2, 8, 32), (5, 8, 2, 32), (torch.int32, (2, 3), True,
                                             "meta"), (5, 8, 2, 1), 24, True,
     "CUDA"),
    ("pool_rank", (2, 8, 32), (5, 8, 64), (torch.int32, (2, 3), True, "meta"),
     None, 24, True, "block pool"),
    ("pool_width", (2, 8, 32), (5, 8, 2, 16), (torch.int32, (2, 3), True,
                                               "meta"), None, 24, True,
     "block pool"),
    ("table_dtype", (2, 8, 32), (5, 8, 2, 32), (torch.int64, (2, 3), True,
                                                "meta"), None, 24, True,
     "tables"),
    ("table_batch", (2, 8, 32), (5, 8, 2, 32), (torch.int32, (3, 3), True,
                                                "meta"), None, 24, True,
     "tables"),
    ("table_layout", (2, 8, 32), (5, 8, 2, 32), (torch.int32, (2, 3), False,
                                                 "meta"), None, 24, True,
     "tables"),
    ("table_device", (2, 8, 32), (5, 8, 2, 32), (torch.int32, (2, 3), True,
                                                 "cpu"), None, 24, True,
     "tables"),
    ("scale_shape", (2, 8, 32), (5, 8, 2, 32), (torch.int32, (2, 3), True,
                                                "meta"), (2, 24, 2, 1), 24,
     True, "scales"),
    ("window", (2, 8, 32), (5, 8, 2, 32), (torch.int32, (2, 3), True,
                                           "meta"), None, 0, True, "window"),
    ("lengths_mode", (2, 8, 32), (5, 8, 2, 32), (torch.int32, (2, 3), True,
                                                 "meta"), None, 24, False,
     "ring"),
]


@pytest.mark.parametrize("case", REFUSALS, ids=[c[0] for c in REFUSALS])
def test_table_mode_wrapper_refuses_before_the_device_check(case):
    """The wrapper checks the pool, the scales, the table and the window
    before it looks at the device (these tensors are on ``meta``): a bad
    one raises ValueError naming it, a good one stops at the device
    check; nothing launches."""
    _, qs, pool, (tdt, tshape, contiguous, tdev), scale, window, ring, msg = \
        case
    _build.reset_launches()
    q = torch.empty(qs, device="meta")
    kdt = torch.int8 if scale is not None else torch.float32
    k = torch.empty(pool, dtype=kdt, device="meta")
    tables = torch.empty(tshape[::-1] if not contiguous else tshape,
                         dtype=tdt, device=tdev)
    if not contiguous:
        tables = tables.t()
    sc = None if scale is None else torch.empty(scale, device="meta")
    lens = torch.empty((2,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match=msg):
        tda_kernel.decode_attention_cuda(q, k, k, lens, sc, sc, window,
                                         ring=ring, tables=tables)
    assert _build.launches["decode_attention"] == 0
    assert _build.launches["decode_attention_table"] == 0


# --- the paged model ---------------------------------------------------------

@pytest.fixture(scope="module")
def smoke():
    jcfg, tcfg = JC.get_smoke(ARCH), TC.get_smoke(ARCH)
    params = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    carried = params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                                device="cpu")
    return jcfg, tcfg, params, carried


def _carry(tree):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, tree),
                             device="cpu")


@pytest.mark.parametrize("abits", [pytest.param(None, id="uniform:4"),
                                   pytest.param(8, id="uniform:4a8")])
@pytest.mark.parametrize("quant_kv", [pytest.param(False, id="f32kv"),
                                      pytest.param(True, id="int8kv")])
def test_paged_decode_step_matches_reference(smoke, abits, quant_kv):
    """The reference prefills two prompts into a block pool through
    shuffled tables; the port decodes from the same pool (carried across)
    and tables, one lane masked with its table all trash, crossing block
    boundaries: logits within LOGIT_TOL of the reference's each step."""
    jcfg, tcfg, params, _ = smoke
    jp, _, _ = jquantize(params, JPolicy(bits=4, group_size=32,
                                         min_size=1024, act_bits=abits))
    tp = _carry(jp)
    rng = np.random.default_rng(11)
    b, bs, mbs, nb = 3, 4, 6, 20
    trash = nb
    lengths = np.array([7, 4, 1], np.int32)
    prompt = rng.integers(0, jcfg.vocab, size=(b, 8))
    perm = rng.permutation(nb)
    tables = np.full((b, mbs), trash, np.int32)
    tables[0], tables[1] = perm[:mbs], perm[mbs:2 * mbs]
    phys = np.full((b, 8), trash, np.int32)
    offs = np.tile(np.arange(8) % bs, (b, 1)).astype(np.int32)
    for i in range(2):
        phys[i, :lengths[i]] = tables[i, np.arange(lengths[i]) // bs]
    jcache = jlm.init_paged_cache(jp, jcfg, b, nb + 1, bs, quant_kv)
    jl, jcache = jlm.prefill_into_blocks(
        jp, jnp.asarray(prompt), jcache, np.arange(b), phys.ravel(),
        offs.ravel(), jcfg, quant_kv=quant_kv, lengths=jnp.asarray(lengths))
    tcache = jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.array(a)), jcache)
    mask = np.array([True, True, False])
    tok = np.asarray(jnp.argmax(jl, -1))[:, None]
    for _ in range(6):
        jl, jcache = jlm.decode_step(
            jp, jnp.asarray(tok), jcache, jcfg, quant_kv,
            active_mask=jnp.asarray(mask), block_tables=jnp.asarray(tables))
        tl, tcache = tlm.decode_step(
            tp, tok, tcache, tcfg, quant_kv, active_mask=mask, device="cpu",
            block_tables=torch.from_numpy(tables))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
        np.testing.assert_array_equal(tcache["length"].numpy(),
                                      np.asarray(jcache["length"]))
        tok = np.asarray(jnp.argmax(jl, -1))[:, None]
    assert int(tcache["length"][0]) == 13          # crossed 2 boundaries


def test_paged_prefill_scatters_as_reference(smoke):
    """``prefill_into_blocks`` writes each live row where the reference's
    does (f32 KV: the same values within LOGIT_TOL), leaves shared and
    untouched blocks as they were, and the copy-on-write copy duplicates a
    block in place."""
    jcfg, tcfg, params, carried = smoke
    rng = np.random.default_rng(5)
    bs, nb, trash = 4, 6, 6
    prompt = rng.integers(0, jcfg.vocab, size=(2, 8))
    lengths = np.array([8, 5], np.int32)
    phys = np.array([[0, 0, 0, 0, 3, 3, 3, 3], [2, 2, 2, 2, 4, trash, trash,
                                                 trash]], np.int32)
    offs = np.tile(np.arange(8) % bs, (2, 1)).astype(np.int32)
    jcache = jlm.init_paged_cache(params, jcfg, 2, nb + 1, bs, False)
    _, jcache = jlm.prefill_into_blocks(
        params, jnp.asarray(prompt), jcache, np.arange(2), phys.ravel(),
        offs.ravel(), jcfg, lengths=jnp.asarray(lengths))
    tcache = tlm.init_paged_cache(tcfg, 2, nb + 1, bs, device="cpu")
    tcache["layers"]["k"][:, 1] = 7.0              # a block nobody writes
    _, tcache = tlm.prefill_into_blocks(
        carried, prompt, tcache, np.arange(2), phys.ravel(), offs.ravel(),
        tcfg, lengths=lengths, device="cpu")
    for name in ("k", "v"):
        got, ref = tcache["layers"][name].numpy(), np.asarray(
            jcache["layers"][name])
        np.testing.assert_allclose(got[:, [0, 2, 3, 4]], ref[:, [0, 2, 3, 4]],
                                   **LOGIT_TOL)
    assert bool((tcache["layers"]["k"][:, 1] == 7.0).all())
    np.testing.assert_array_equal(tcache["length"].numpy(), lengths)
    before = {n: a.clone() for n, a in tcache["layers"].items()}
    tlm._copy_blocks(tcache["layers"], torch.tensor([0, 3]),
                     torch.tensor([3, 5]))
    for name, a in tcache["layers"].items():
        assert torch.equal(a[:, 3], before[name][:, 0])
        assert torch.equal(a[:, 5], before[name][:, 3])


# --- the paged engine --------------------------------------------------------

PREFIX = [5, 9, 2, 4, 11, 3, 8, 1]
PROMPTS = [PREFIX + [7, 6], PREFIX + [10, 12], PREFIX + [7, 6],
           [1, 2, 3], PREFIX + [13, 14, 15], PREFIX + [7, 6]]
FIELDS = dict(batch_size=4, cache_len=64, ql=4, group_size=32, quant_kv=True)


def _serve(engine, prompts, max_new):
    uids = [engine.submit(list(p), max_new) for p in prompts]
    engine.run()
    return {u: engine.completions[u].tokens for u in uids}


@pytest.fixture(scope="module")
def ring_tokens(smoke):
    """The port's ring engine on PROMPTS, per max_new."""
    _, tcfg, _, carried = smoke
    return {n: _serve(TEngine(carried, tcfg, TEngineConfig(**FIELDS),
                              device="cpu"), PROMPTS, n) for n in (6, 8)}


# (paged fields, max_new): plain (no sharing), with prefix sharing, and a
# pool of 7 blocks (clamped to one lane's 8) that forces preemption
PAGED = {"plain": (dict(kv_block_size=8, share_prefix=False), 6),
         "sharing": (dict(kv_block_size=8), 6),
         "preemption": (dict(kv_block_size=8, kv_pool_blocks=7), 8)}


@pytest.mark.parametrize("mode", list(PAGED))
def test_paged_engine_matches_reference_and_ring(smoke, ring_tokens, mode):
    """Greedy completions of the port's paged engine equal the reference's
    paged engine's and the port's own ring engine's; the block pool's
    stats and the per-request iteration marks equal the reference's; all
    blocks come back."""
    jcfg, tcfg, params, carried = smoke
    paged, max_new = PAGED[mode]
    ref_engine = JEngine(params, jcfg, JEngineConfig(**FIELDS, **paged))
    port_engine = TEngine(carried, tcfg, TEngineConfig(**FIELDS, **paged),
                          device="cpu")
    ref = _serve(ref_engine, PROMPTS, max_new)
    got = _serve(port_engine, PROMPTS, max_new)
    assert got == ref == ring_tokens[max_new]
    st, jst = port_engine.stats(), ref_engine.stats()
    assert st["block_pool"] == jst["block_pool"]
    for key in ("iterations", "prefill_iterations", "decode_iterations",
                "prefill_tokens", "peak_active"):
        assert st[key] == jst[key], key
    assert port_engine.events == ref_engine.events
    pool = st["block_pool"]
    assert pool["used_blocks"] == 0
    port_engine.block_mgr.check_invariants()
    assert (pool["shared_hits"] > 0) == (mode != "plain")
    if mode == "preemption":
        assert pool["preemptions"] > 0
        assert any("resumed_iteration" in ev
                   for ev in port_engine.events.values())
    else:
        assert pool["preemptions"] == 0


def test_equal_kv_memory_admits_more_users(smoke):
    """The reference's admission property: at one KV byte budget (2 slots
    of 64 tokens, or 16 blocks of 8), the paged pool with prefix sharing
    holds more requests in flight than the slot pool."""
    _, tcfg, _, carried = smoke
    prompts = [PREFIX + [i, i + 1] for i in range(8)]
    slot = TEngine(carried, tcfg, TEngineConfig(**{**FIELDS,
                                                   "batch_size": 2}),
                   device="cpu")
    paged = TEngine(carried, tcfg, TEngineConfig(
        **{**FIELDS, "batch_size": 8}, kv_block_size=8, kv_pool_blocks=16),
        device="cpu")
    assert paged.cache["layers"]["k"][:, :16].numel() == \
        slot.cache["layers"]["k"].numel()
    for eng in (slot, paged):
        assert sorted(map(len, _serve(eng, prompts, 6).values())) == [6] * 8
    assert paged.stats()["peak_active"] > slot.stats()["peak_active"]


def test_paged_engine_sizes_refuses_and_raises(smoke, monkeypatch):
    """A request longer than a lane's table raises ValueError; the pool is
    sized by a byte budget at the KV precision (clamped to one lane); an
    exhausted pool with preemption off raises MemoryError; a plan's
    ``kv=32`` sizes an f32 pool at its own bytes, and ``kv=auto`` (the
    Planner's) points at ROADMAP; without ``device=``
    the paged engine asks for CUDA and raises when there is none."""
    _, tcfg, _, carried = smoke
    eng = TEngine(carried, tcfg, TEngineConfig(**FIELDS, kv_block_size=8),
                  device="cpu")
    with pytest.raises(ValueError, match="never wrap"):
        eng.submit(list(range(60)), 10)            # 70 > 64-token lane
    budget = 40 * tcost.kv_block_bytes(8, tcfg.n_layers, tcfg.n_kv,
                                       tcfg.head_dim, 8)
    sized = TEngine(carried, tcfg, TEngineConfig(
        **FIELDS, kv_block_size=8, kv_budget_bytes=budget), device="cpu")
    assert sized.block_mgr.num_blocks == 40
    assert sized.cache["layers"]["k"].shape[:3] == (tcfg.n_layers, 41, 8)
    tiny = TEngine(carried, tcfg, TEngineConfig(
        **FIELDS, kv_block_size=8, kv_budget_bytes=1), device="cpu")
    assert tiny.block_mgr.num_blocks == 8
    dry = TEngine(carried, tcfg, TEngineConfig(
        **FIELDS, kv_block_size=8, kv_pool_blocks=8, preempt=False),
        device="cpu")
    for p in PROMPTS[:4]:
        dry.submit(list(p), 40)
    with pytest.raises(MemoryError, match="preempt"):
        dry.run()
    # the plan's KV precision overrides quant_kv, for the pool and for
    # its byte pricing; kv=auto is resolved by the Planner's KV probe
    budget32 = 40 * tcost.kv_block_bytes(8, tcfg.n_layers, tcfg.n_kv,
                                         tcfg.head_dim, 32)
    f32 = TEngine(carried, tcfg, TEngineConfig(
        **{**FIELDS, "plan": "uniform:4,kv=32"}, kv_block_size=8,
        kv_budget_bytes=budget32), device="cpu")
    assert f32.block_mgr.num_blocks == 40 and f32.kv_bits == 32
    assert f32.cache["layers"]["k"].dtype == torch.float32
    assert "k_scale" not in f32.cache["layers"]
    auto = TEngine(carried, tcfg, TEngineConfig(
        **{**FIELDS, "plan": "uniform:4,kv=auto"}, kv_block_size=8,
        kv_budget_bytes=budget32), device="cpu")
    assert auto.kv_bits in (8, 32) and auto.plan.kv_bits == auto.kv_bits
    assert auto.block_mgr.num_blocks == tcost.kv_pool_blocks(
        budget32, 8, tcfg.n_layers, tcfg.n_kv, tcfg.head_dim, auto.kv_bits)
    assert auto.cache["layers"]["k"].dtype == (
        torch.int8 if auto.kv_bits == 8 else torch.float32)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TEngine(carried, tcfg, TEngineConfig(**FIELDS, kv_block_size=8))
    with pytest.raises(RuntimeError, match="CUDA"):
        tlm.init_paged_cache(tcfg, 2, 4, 8)
