"""The port's training substrate against the JAX reference: AdamW and its
schedule, the synthetic data stream, checkpoints (a directory written by
either package restores bit-equal in the other) and the fault-tolerant
loop (the loss falls, resume is bit-exact, the NaN budget, SIGTERM)."""
import os
import signal

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

import repro.checkpoint as jck
import repro_torch.configs as TC
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.optim.adamw import AdamW as JAdamW
from repro.optim.adamw import AdamWState as JAdamWState
from repro.optim.adamw import cosine_schedule as j_cosine_schedule
from repro_torch.checkpoint import (AsyncCheckpointer, _msgpack, keep_last,
                                    latest_step, restore, save)
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.models import lm
from repro_torch.optim.adamw import AdamW, AdamWState, cosine_schedule
from repro_torch.training.loop import TrainLoop, TrainLoopConfig
from repro_torch.tree import (tree_flatten_with_path, tree_leaves, tree_map,
                              tree_unflatten)

OPT_RTOL = 1e-6      # AdamW's params / mu / nu, relative to each leaf's max


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's smoke-sized CPU ops are tiny: one intra-op thread runs
    them fastest, and keeps them off the other test workers' cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def numpy_tree(seed=0):
    """A small tree of the port's kinds: dicts, a list, 2-D and 1-D
    leaves (weight decay applies to the 2-D ones only)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return {"w": f(4, 3), "b": f(3), "blocks": [{"x": f(2, 5)},
                                                {"x": f(2, 5), "s": f(5)}]}


def to_torch(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def assert_tree_close(got, want, rtol):
    for (path, g), w in zip(tree_flatten_with_path(got),
                            jax.tree_util.tree_leaves(want)):
        g, w = np.asarray(g), np.asarray(w)
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(g - w).max()) <= rtol * scale, path


# --- optimizer --------------------------------------------------------------

@pytest.mark.parametrize("clip", [1.0, None], ids=["clip", "no_clip"])
def test_adamw_matches_reference(clip):
    """Five steps fed the same numpy gradients, under the cosine schedule
    (warmup 2): params, mu and nu within 1e-6 of each leaf's max, the
    step counter and the grad norm alike."""
    kw = dict(weight_decay=0.1, clip_norm=clip)
    jopt = JAdamW(learning_rate=j_cosine_schedule(1e-2, 2, 10), **kw)
    topt = AdamW(learning_rate=cosine_schedule(1e-2, 2, 10), **kw)
    tree = numpy_tree()
    jp, tp = to_jax(tree), to_torch(tree)
    js, ts = jopt.init(jp), topt.init(tp)
    assert ts.step.dtype == torch.int32 and ts.step.ndim == 0
    for i in range(5):
        g = tree_map(lambda a: 3 * a, numpy_tree(seed=10 + i))
        ju, js, jn = jopt.update(to_jax(g), js, jp)
        jp = jopt.apply(jp, ju)
        tu, ts, tn = topt.update(to_torch(g), ts, tp)
        tp = topt.apply(tp, tu)
        assert int(ts.step) == int(js.step) == i + 1
        assert abs(float(tn) - float(jn)) <= OPT_RTOL * float(jn)
    assert_tree_close(tp, jp, OPT_RTOL)
    assert_tree_close(ts.mu, js.mu, OPT_RTOL)
    assert_tree_close(ts.nu, js.nu, OPT_RTOL)
    assert not any(p.requires_grad for p in tree_leaves(tp))


def test_adamw_minimizes_quadratic():
    opt = AdamW(learning_rate=0.1, weight_decay=0.0, clip_norm=None)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = opt.init(params)
    for _ in range(300):
        g = {"w": 2 * params["w"]}
        upd, state, _ = opt.update(g, state, params)
        params = opt.apply(params, upd)
    assert float(params["w"].abs().max()) < 1e-2


def test_cosine_schedule():
    fn = cosine_schedule(1.0, 10, 100)
    jfn = j_cosine_schedule(1.0, 10, 100)
    assert float(fn(torch.tensor(0))) == 0.0
    assert float(fn(torch.tensor(10))) == pytest.approx(1.0)
    assert float(fn(torch.tensor(100))) == pytest.approx(0.1, rel=0.01)
    for s in (0, 3, 10, 37, 99, 100, 150):
        assert float(fn(torch.tensor(s, dtype=torch.int32))) == \
            pytest.approx(float(jfn(jnp.array(s, jnp.int32))), rel=1e-6)


def test_grad_clip():
    opt = AdamW(learning_rate=1.0, clip_norm=1.0)
    params = {"w": torch.zeros(3)}
    state = opt.init(params)
    _, _, gnorm = opt.update({"w": torch.full((3,), 100.0)}, state, params)
    assert float(gnorm) == pytest.approx(np.sqrt(3) * 100, rel=1e-4)


# --- data -------------------------------------------------------------------

def test_data_bit_equal_to_reference():
    """Batches of both streams bit-equal: tokens and the vision stub, per
    host of two, after a resume."""
    kw = dict(vocab=97, seq_len=12, global_batch=4, seed=3, n_hosts=2,
              frontend="vision", frontend_tokens=3, d_model=8)
    for host in (0, 1):
        t = SyntheticLM(DataConfig(host_id=host, **kw))
        j = JSyntheticLM(JDataConfig(host_id=host, **kw))
        for _ in range(3):
            bt, bj = t.next_batch(), j.next_batch()
            assert sorted(bt) == sorted(bj) == ["prefix_embeds", "tokens"]
            for k in bt:
                assert bt[k].dtype == bj[k].dtype
                assert np.array_equal(bt[k], bj[k])
        t.load_state_dict({"step": 1})
        j.load_state_dict({"step": 1})
        assert np.array_equal(t.next_batch()["tokens"],
                              j.next_batch()["tokens"])
        assert t.state_dict() == j.state_dict() == {"step": 2}


def test_data_determinism_and_resume():
    cfg = DataConfig(vocab=128, seq_len=16, global_batch=4)
    d1 = SyntheticLM(cfg)
    b1 = [d1.next_batch()["tokens"] for _ in range(3)]
    d2 = SyntheticLM(cfg)
    d2.load_state_dict({"step": 2})
    assert (d2.next_batch()["tokens"] == b1[2]).all()


def test_data_host_sharding():
    h0 = SyntheticLM(DataConfig(vocab=64, seq_len=8, global_batch=8,
                                n_hosts=2, host_id=0))
    h1 = SyntheticLM(DataConfig(vocab=64, seq_len=8, global_batch=8,
                                n_hosts=2, host_id=1))
    assert h0.next_batch()["tokens"].shape[0] == 4
    assert not (h0._batch_rng(0).integers(0, 1 << 30) ==
                h1._batch_rng(0).integers(0, 1 << 30))
    with pytest.raises(ValueError):
        SyntheticLM(DataConfig(vocab=64, seq_len=8, global_batch=7,
                               n_hosts=2))


# --- checkpoint -------------------------------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.ones(4, dtype=torch.int32)}}
    save(str(tmp_path), 7, tree, extras={"note": "x"})
    out, extras = restore(str(tmp_path), tree)
    assert extras["note"] == "x"
    assert torch.equal(out["a"], tree["a"])
    assert out["b"]["c"].dtype == torch.int32
    assert latest_step(str(tmp_path)) == 7


def test_checkpoint_gc_and_latest(tmp_path):
    tree = {"a": torch.zeros(2)}
    for s in (1, 2, 3, 4):
        save(str(tmp_path), s, tree)
    keep_last(str(tmp_path), 2)
    dirs = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert dirs == ["step_00000003", "step_00000004"]
    os.remove(tmp_path / "LATEST")           # the directory scan
    assert latest_step(str(tmp_path)) == 4
    assert latest_step(str(tmp_path / "none")) is None


def test_async_checkpointer(tmp_path):
    ck = AsyncCheckpointer(str(tmp_path))
    w = torch.ones(5)
    ck.save(3, {"w": w})
    w.zero_()                     # the host copy was taken before the write
    ck.wait()
    out, _ = restore(str(tmp_path), {"w": torch.zeros(5)})
    assert (out["w"] == 1).all()


def test_async_checkpointer_reraises(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    ck = AsyncCheckpointer(str(blocker))
    ck.save(1, {"w": torch.ones(2)})
    with pytest.raises(OSError):
        ck.wait()
    ck.wait()                     # the error is reported once


def test_checkpoint_structure_mismatch(tmp_path):
    save(str(tmp_path), 1, {"a": torch.zeros(2)})
    with pytest.raises(ValueError, match="leaves"):
        restore(str(tmp_path), {"a": torch.zeros(2), "b": torch.zeros(1)})
    with pytest.raises(ValueError, match="shape mismatch"):
        restore(str(tmp_path), {"a": torch.zeros(3)})


def train_state(seed=0):
    """(params, AdamW state) as numpy trees: the loop's checkpoint."""
    tree = numpy_tree(seed)
    rng = np.random.default_rng(seed + 1)
    moments = lambda: tree_map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32), tree)
    return tree, (np.asarray(7, np.int32), moments(), moments())


def test_reference_checkpoint_restores_in_port(tmp_path):
    tree, (step, mu, nu) = train_state()
    jck.save(str(tmp_path), 5, (to_jax(tree), JAdamWState(
        jnp.asarray(step), to_jax(mu), to_jax(nu))),
        extras={"step": 5, "data": {"step": 5}})
    template = (to_torch(tree), AdamWState(
        torch.zeros((), dtype=torch.int32), to_torch(mu), to_torch(nu)))
    template = tree_map(torch.zeros_like, template)
    (params, state), extras = restore(str(tmp_path), template)
    assert extras == {"step": 5, "data": {"step": 5}}
    assert isinstance(state, AdamWState) and int(state.step) == 7
    assert state.step.dtype == torch.int32
    for got, want in zip(tree_leaves((params, state)),
                         tree_leaves((tree, (step, mu, nu)))):
        assert np.array_equal(got.numpy(), want)


def test_port_checkpoint_restores_in_reference(tmp_path):
    tree, (step, mu, nu) = train_state(seed=4)
    port = (to_torch(tree), AdamWState(torch.from_numpy(step), to_torch(mu),
                                       to_torch(nu)))
    save(str(tmp_path), 9, port, extras={"step": 9, "data": {"step": 9}})
    template = (to_jax(tree), JAdamWState(jnp.zeros((), jnp.int32),
                                          to_jax(mu), to_jax(nu)))
    template = jax.tree_util.tree_map(jnp.zeros_like, template)
    out, extras = jck.restore(str(tmp_path), template)
    assert extras == {"step": 9, "data": {"step": 9}}
    assert jck.latest_step(str(tmp_path)) == 9
    for got, want in zip(jax.tree_util.tree_leaves(out),
                         tree_leaves((tree, (step, mu, nu)))):
        assert np.array_equal(np.asarray(got), want)
        assert np.asarray(got).dtype == want.dtype
    # the manifest names each leaf as the reference's would
    with open(tmp_path / "step_00000009" / "manifest.msgpack", "rb") as f:
        meta = msgpack.unpackb(f.read())
    jpaths = [jax.tree_util.keystr(p) for p, _ in
              jax.tree_util.tree_flatten_with_path(template)[0]]
    assert [r["path"] for r in meta["leaves"]] == jpaths


def test_msgpack_matches_the_package():
    obj = {"step": 70000, "leaves": [
        {"id": "leaf00000", "path": "[0]['w']", "shape": [4, 3],
         "dtype": "float32"}] * 20,
        "extras": {"neg": [-1, -33, -200, -40000, -3000000000],
                   "big": [127, 128, 300, 70000, 5000000000],
                   "f": 0.1, "t": True, "n": None, "s": "x" * 40,
                   "long": "y" * 300, "many": list(range(20)),
                   "map": {str(i): i for i in range(20)}}}
    assert _msgpack.packb(obj) == msgpack.packb(obj)
    assert _msgpack.unpackb(msgpack.packb(obj)) == msgpack.unpackb(
        msgpack.packb(obj))


# --- training loop (fault tolerance) ---------------------------------------

def make_loop(tmp_path, steps=8, step_fn=None, **lcfg):
    cfg = TC.get_smoke("llama3_2_1b")
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    opt = AdamW(learning_rate=1e-3)
    opt_state = opt.init(params)

    def step(params, opt_state, batch):
        fp = tree_map(lambda p: p.detach().requires_grad_(), params)
        loss, m = lm.loss_fn(fp, batch, cfg, device="cpu")
        g = torch.autograd.grad(loss, tree_leaves(fp))
        upd, opt_state, gnorm = opt.update(tree_unflatten(params, g),
                                           opt_state, params)
        return opt.apply(params, upd), opt_state, {
            "loss": loss.detach(), "grad_norm": gnorm,
            "nll": m["nll"].detach()}

    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=32,
                                  global_batch=4))
    kw = dict(total_steps=steps, log_every=2, checkpoint_every=4,
              checkpoint_dir=str(tmp_path))
    kw.update(lcfg)
    return TrainLoop(step_fn(step) if step_fn else step, params, opt_state,
                     data, TrainLoopConfig(**kw))


def test_train_loss_decreases(tmp_path):
    result = make_loop(tmp_path, steps=30).run()
    losses = [r["loss"] for r in result["log"]]
    assert losses[-1] < losses[0]
    assert result["final_step"] == 30 and not result["preempted"]


def test_train_checkpoint_resume_bit_exact(tmp_path):
    """4 steps, a restart, 4 more: the losses of steps 5-8 and the final
    parameters equal those of one uninterrupted 8-step run, bit for bit."""
    full = make_loop(tmp_path / "full", steps=8, log_every=1)
    want = full.run()["log"]
    loop1 = make_loop(tmp_path / "a", steps=4, log_every=1)
    loop1.run()
    assert latest_step(str(tmp_path / "a")) == 4
    loop2 = make_loop(tmp_path / "a", steps=8, log_every=1)
    assert loop2.maybe_restore()
    assert loop2.step == 4
    assert loop2.data.state.step == 4
    assert int(loop2.opt_state.step) == 4
    result = loop2.run()
    assert result["final_step"] == 8
    assert [r["loss"] for r in result["log"]] == \
        [r["loss"] for r in want[4:]]
    for a, b in zip(tree_leaves(loop2.params), tree_leaves(full.params)):
        assert torch.equal(a, b)
    assert not make_loop(tmp_path / "empty").maybe_restore()


def test_nan_budget(tmp_path):
    """Two non-finite losses within a budget of 3 are skipped (params kept,
    the data stream advanced); a fourth in a row raises."""
    calls = {"n": 0}

    def sometimes_nan(step):
        def fn(p, o, b):
            calls["n"] += 1
            p2, o2, m = step(p, o, b)
            if calls["n"] in (2, 3):
                m = dict(m, loss=torch.tensor(float("nan")))
            return p2, o2, m
        return fn

    loop = make_loop(tmp_path / "a", steps=4, step_fn=sometimes_nan,
                     checkpoint_dir=None)
    result = loop.run()
    assert result["final_step"] == 4
    assert loop.data.state.step == 6 and loop._nan_skips == 2

    def always_nan(step):
        return lambda p, o, b: (p, o, {"loss": torch.tensor(float("inf")),
                                       "grad_norm": torch.tensor(0.0)})

    with pytest.raises(FloatingPointError):
        make_loop(tmp_path / "b", steps=10, step_fn=always_nan,
                  checkpoint_dir=None).run()


def test_sigterm_asks_for_final_checkpoint(tmp_path):
    old = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    calls = {"n": 0}

    def preempted_at_3(step):
        def fn(p, o, b):
            calls["n"] += 1
            if calls["n"] == 3:
                os.kill(os.getpid(), signal.SIGTERM)
            return step(p, o, b)
        return fn

    loop = make_loop(tmp_path, steps=20, step_fn=preempted_at_3,
                     checkpoint_every=100)
    try:
        loop.install_signal_handlers()
        result = loop.run()
    finally:
        for s, h in old.items():
            signal.signal(s, h)
    assert result["preempted"] and result["final_step"] == 3
    assert latest_step(str(tmp_path)) == 3
    resumed = make_loop(tmp_path, steps=5)
    assert resumed.maybe_restore() and resumed.step == 3
    assert resumed.run()["final_step"] == 5


def test_watchdog_reports_a_straggler(tmp_path, capsys):
    """After 21 quick steps, one 5x slower than the trailing median of 20
    is reported; the loop goes on."""
    import time
    calls = {"n": 0}

    def slow_at_23(step):
        def fn(p, o, b):
            calls["n"] += 1
            time.sleep(0.2 if calls["n"] == 23 else 0.002)
            return p, o, {"loss": torch.tensor(1.0),
                          "grad_norm": torch.tensor(0.0)}
        return fn

    result = make_loop(tmp_path, steps=25, step_fn=slow_at_23,
                       checkpoint_dir=None).run()
    out = capsys.readouterr().out
    assert result["final_step"] == 25
    assert out.count("[watchdog]") == 1
    assert "[watchdog] step 23 took" in out
