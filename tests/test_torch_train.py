"""The port's training path against the JAX reference, on smoke configs:
``lm.loss_fn`` / ``encdec.loss_fn`` values and gradients against
``jax.value_and_grad`` on the same numpy weights (remat on and off, xlstm
through ``_chunked_scan``'s chunked branch), ``chunked_nll``, the train
step at microbatches 1 and 2, under bf16 and at the reference's defaults,
train -> quantize -> serve, and the launcher."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro_torch.configs as TC
from repro.launch.mesh import make_mesh
from repro.launch.steps import auto_microbatches as j_auto_microbatches
from repro.launch.steps import build_train_step as j_build_train_step
from repro.models import encdec as jencdec
from repro.models import lm as jlm
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch import train as ttrain
from repro_torch.launch.steps import build_train_step
from repro_torch.models import encdec as tencdec
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm
from repro_torch.models import remat as tremat
from repro_torch.models import xlstm as txlstm
from repro_torch.models.sail_linear import QuantPolicy, quantize_params
from repro_torch.optim.adamw import AdamW
from repro_torch.serving.engine import Engine, EngineConfig
from repro_torch.tree import (tree_flatten_with_path, tree_leaves, tree_map,
                              tree_unflatten)

from _torch_models import numpy_params

LOSS_RTOL = 1e-5           # loss, relative
GRAD_TOL = 1e-5            # each gradient leaf, relative to its max |g|
BF16_RTOL = 2e-2           # the loss under bf16 compute

# (arch, batch, sequence): xlstm at T 256 so that its recurrences run
# _chunked_scan's chunked branch (T > 128, 128 | T)
CASES = [("tinymistral_248m", 2, 16), ("granite_moe_1b_a400m", 2, 16),
         ("hymba_1_5b", 2, 16), ("xlstm_350m", 1, 256),
         ("phi_3_vision_4_2b", 2, 16), ("llama3_2_1b", 2, 16),
         ("whisper_large_v3", 2, 16)]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's smoke-sized CPU ops are tiny: one intra-op thread runs
    them fastest, and keeps them off the other test workers' cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def make_batch(cfg, b, t, seed=1):
    """Seeded numpy batch: tokens [b, t + 1]; phi-3-vision's prefix
    embeddings, whisper's frames."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, t + 1)).astype(
        np.int32)}
    if cfg.frontend == "vision":
        batch["prefix_embeds"] = rng.standard_normal(
            (b, cfg.vision_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (b, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return batch


_REFERENCE = {}


def reference_value_and_grad(arch, b, t):
    """The reference's (loss, nll, {path: grad}) on seed-0 numpy weights,
    computed once per case."""
    if arch not in _REFERENCE:
        jcfg = JC.get_smoke(arch)
        tree = numpy_params(jcfg)
        batch = {k: jnp.asarray(v) for k, v in
                 make_batch(jcfg, b, t).items()}
        loss = (jencdec.loss_fn if jcfg.family == "encdec" else jlm.loss_fn)
        (l, m), g = jax.jit(jax.value_and_grad(
            lambda p: loss(p, batch, jcfg), has_aux=True))(
                jax.tree_util.tree_map(jnp.asarray, tree))
        grads = {jax.tree_util.keystr(p): np.asarray(v) for p, v in
                 jax.tree_util.tree_flatten_with_path(g)[0]}
        _REFERENCE[arch] = (tree, float(l), float(m["nll"]), grads)
    return _REFERENCE[arch]


def port_value_and_grad(tree, cfg, batch):
    params = tree_map(lambda p: p.requires_grad_(),
                      params_from_numpy(tree, device="cpu"))
    loss = tencdec.loss_fn if cfg.family == "encdec" else tlm.loss_fn
    l, m = loss(params, batch, cfg, device="cpu")
    flat = tree_flatten_with_path(params)
    gs = torch.autograd.grad(l, [p for _, p in flat])
    return (l.detach(), {k: v.detach() for k, v in m.items()},
            {path: g.numpy() for (path, _), g in zip(flat, gs)})


def assert_grads_close(got, want, tol=GRAD_TOL):
    """Each leaf within ``tol`` of its largest reference gradient.  A key
    bias's gradient is 0 in exact arithmetic (softmax is invariant to a
    shift shared by all of a query's scores), so both packages give
    rounding noise there (~1e-8): those leaves are held to ``tol`` of the
    largest gradient of the whole tree instead."""
    assert sorted(got) == sorted(want)
    tree_max = max(float(np.abs(w).max()) for w in want.values())
    for path, w in want.items():
        g = got[path]
        assert g.shape == w.shape, path
        assert np.isfinite(g).all(), path
        scale = (tree_max if path.endswith("['bk']")
                 else max(float(np.abs(w).max()), 1e-30))
        err = float(np.abs(g - w).max()) / scale
        assert err <= tol, f"{path}: {err:.3g} of the leaf's max"


class Counter:
    """Counts the calls of a wrapped ``checkpoint``."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *args, **kw):
        self.calls += 1
        return self.fn(*args, **kw)


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no_remat"])
@pytest.mark.parametrize("arch,b,t", CASES, ids=[c[0] for c in CASES])
def test_loss_and_grads_match_reference(arch, b, t, remat, monkeypatch):
    tree, l_ref, nll_ref, g_ref = reference_value_and_grad(arch, b, t)
    cfg = dataclasses.replace(TC.get_smoke(arch), remat=remat)
    layers = Counter(tremat.checkpoint)
    chunks = Counter(txlstm.checkpoint)
    attns = Counter(tlayers.chunked_attention)
    monkeypatch.setattr(tremat, "checkpoint", layers)
    monkeypatch.setattr(txlstm, "checkpoint", chunks)
    monkeypatch.setattr(tlayers, "chunked_attention", attns)
    l, m, g = port_value_and_grad(tree, cfg, make_batch(cfg, b, t))
    assert abs(float(l) - l_ref) <= LOSS_RTOL * abs(l_ref)
    assert abs(float(m["nll"]) - nll_ref) <= LOSS_RTOL * abs(nll_ref)
    assert_grads_close(g, g_ref)
    n_blocks = (cfg.n_layers + cfg.n_enc_layers if cfg.family == "encdec"
                else tlm.n_scan_blocks(cfg))
    assert layers.calls == (n_blocks if remat else 0)
    # every attention of the loss in the chunked form, again when the
    # backward pass recomputes its layer under remat
    n_attn = {"ssm": 0, "encdec": cfg.n_enc_layers + 2 * cfg.n_layers}.get(
        cfg.family, cfg.n_layers)
    assert attns.calls == n_attn * (2 if remat else 1)
    if cfg.family == "ssm":
        # every mLSTM and sLSTM in two chunks, again when the backward pass
        # recomputes its block under remat
        assert chunks.calls == 2 * cfg.n_layers * (2 if remat else 1)
    else:
        assert chunks.calls == 0


def test_loss_over_several_key_chunks_matches_reference():
    """tinymistral smoke at T 96: three key chunks of 32 under its window
    of 64 (chunks before the window skipped), the loss and every gradient
    within 1e-5 of the reference's."""
    jcfg, cfg = JC.get_smoke("tinymistral_248m"), TC.get_smoke(
        "tinymistral_248m")
    tree = numpy_params(jcfg)
    batch = make_batch(cfg, 2, 96, seed=4)
    (l_ref, m_ref), g = jax.jit(jax.value_and_grad(
        lambda p: jlm.loss_fn(p, {k: jnp.asarray(v) for k, v in
                                  batch.items()}, jcfg), has_aux=True))(
            jax.tree_util.tree_map(jnp.asarray, tree))
    l, m, got = port_value_and_grad(tree, cfg, batch)
    assert abs(float(l) - float(l_ref)) <= LOSS_RTOL * abs(float(l_ref))
    assert_grads_close(got, {jax.tree_util.keystr(p): np.asarray(v)
                             for p, v in
                             jax.tree_util.tree_flatten_with_path(g)[0]})


def test_remat_changes_no_value():
    """Remat on and off: the same loss and gradients, bit for bit."""
    cfg = TC.get_smoke("tinymistral_248m")
    tree = numpy_params(JC.get_smoke("tinymistral_248m"))
    batch = make_batch(cfg, 2, 16)
    l1, _, g1 = port_value_and_grad(tree, cfg, batch)
    l0, _, g0 = port_value_and_grad(
        tree, dataclasses.replace(cfg, remat=False), batch)
    assert float(l1) == float(l0)
    assert all(np.array_equal(g1[k], g0[k]) for k in g0)


def test_no_grad_needed_runs_no_checkpoint(monkeypatch):
    """Serving's plain tensors take the plain path: no checkpoint, and
    the forward's values are unchanged."""
    cfg = TC.get_smoke("xlstm_350m")
    tree = numpy_params(JC.get_smoke("xlstm_350m"))
    params = params_from_numpy(tree, device="cpu")
    layers = Counter(tremat.checkpoint)
    chunks = Counter(txlstm.checkpoint)
    monkeypatch.setattr(tremat, "checkpoint", layers)
    monkeypatch.setattr(txlstm, "checkpoint", chunks)
    toks = make_batch(cfg, 1, 255)["tokens"]
    logits, _ = tlm.forward(params, toks, cfg, device="cpu")
    assert layers.calls == chunks.calls == 0
    assert np.isfinite(logits.numpy()).all()


@pytest.mark.parametrize("transpose", [False, True],
                         ids=["head", "transposed_head"])
def test_chunked_nll_matches_reference(transpose):
    """chunk 8 at T 32 (four chunks) with a partial mask."""
    rng = np.random.default_rng(5)
    b, t, d, v = 2, 32, 16, 40
    x = rng.standard_normal((b, t, d)).astype(np.float32)
    head = (rng.standard_normal((v, d) if transpose else (d, v)) /
            4).astype(np.float32)
    targets = rng.integers(0, v, (b, t)).astype(np.int32)
    mask = (rng.random((b, t)) < 0.7).astype(np.float32)
    want, (gx, gh) = jax.value_and_grad(
        lambda x_, h_: jlm.chunked_nll(x_, h_, jnp.asarray(targets),
                                       jnp.asarray(mask), chunk=8,
                                       transpose_head=transpose),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(head))
    tx = torch.from_numpy(x).requires_grad_()
    th = torch.from_numpy(head).requires_grad_()
    chunks = Counter(tremat.checkpoint)
    orig, tremat.checkpoint = tremat.checkpoint, chunks
    try:
        got = tlm.chunked_nll(tx, th, torch.from_numpy(targets).long(),
                              torch.from_numpy(mask), chunk=8,
                              transpose_head=transpose)
    finally:
        tremat.checkpoint = orig
    assert chunks.calls == 4
    want = float(want)
    assert abs(float(got.detach()) - want) <= LOSS_RTOL * abs(want)
    dx, dh = torch.autograd.grad(got, [tx, th])
    assert_grads_close({"x": dx.numpy(), "h": dh.numpy()},
                       {"x": np.asarray(gx), "h": np.asarray(gh)})


def reference_steps(jcfg, tree, batches, **kw):
    mesh = make_mesh((1, 1), ("data", "model"))
    built = j_build_train_step(jcfg, mesh, **kw)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    opt_state = built.meta["optimizer"].init(params)
    out = []
    with mesh:
        for batch in batches:
            params, opt_state, m = built.fn(
                params, opt_state, {k: jnp.asarray(v) for k, v in
                                    batch.items()})
            out.append({k: float(v) for k, v in m.items()})
    return out


@pytest.mark.parametrize("microbatches,bf16", [(1, False), (2, False),
                                               (1, True)],
                         ids=["mb1", "mb2", "bf16"])
def test_train_step_matches_reference(microbatches, bf16):
    """Three steps of ``build_train_step`` against the reference's: the
    loss within 1e-5 relative (bf16 compute: 2e-2), the grad norm alike,
    the step counter equal."""
    arch = "tinymistral_248m"
    jcfg, cfg = JC.get_smoke(arch), TC.get_smoke(arch)
    tree = numpy_params(jcfg)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=16,
                                  global_batch=4))
    batches = [data.next_batch() for _ in range(3)]
    want = reference_steps(jcfg, tree, batches, microbatches=microbatches,
                           bf16_compute=bf16)
    built = build_train_step(cfg, microbatches=microbatches,
                             bf16_compute=bf16, device="cpu")
    check_steps(built, tree, batches, want,
                BF16_RTOL if bf16 else LOSS_RTOL)


def test_default_train_step_matches_reference():
    """``build_train_step(cfg, None)`` against the reference's
    ``build_train_step(jcfg, mesh)``, both at every default (train_4k,
    ``auto_microbatches``' count, bf16 compute): three steps, the
    metrics within 2e-2 relative."""
    arch = "tinymistral_248m"
    jcfg, cfg = JC.get_smoke(arch), TC.get_smoke(arch)
    tree = numpy_params(jcfg)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=16,
                                  global_batch=4))
    batches = [data.next_batch() for _ in range(3)]
    want = reference_steps(jcfg, tree, batches)
    built = build_train_step(cfg, None, device="cpu")
    assert built.meta["microbatches"] == j_auto_microbatches(
        jcfg, make_mesh((1, 1), ("data", "model")), "train_4k")
    check_steps(built, tree, batches, want, BF16_RTOL)


def check_steps(built, tree, batches, want, tol):
    """The port's step from ``tree`` over ``batches``, each step's metrics
    within ``tol`` relative of ``want``'s and its counter equal; the
    masters stay plain f32 tensors."""
    params = params_from_numpy(tree, device="cpu")
    opt_state = built.meta["optimizer"].init(params)
    for batch, w in zip(batches, want):
        params, opt_state, m = built.fn(
            params, opt_state, {k: torch.from_numpy(v)
                                for k, v in batch.items()})
        assert int(m["step"]) == w["step"]
        for key in ("loss", "nll", "grad_norm"):
            assert abs(float(m[key]) - w[key]) <= tol * abs(w[key]), key
    # the masters stay plain f32 tensors
    assert all(p.dtype == torch.float32 and not p.requires_grad
               for p in tree_leaves(params))


@pytest.mark.parametrize("arch,b,t", CASES, ids=[c[0] for c in CASES])
def test_bf16_compute_runs_every_family(arch, b, t):
    """One step under ``bf16_compute`` against one in f32 from the same
    weights and batch (numpy batch entries accepted): the loss within
    2e-2 relative, the masters f32 and finite (xlstm at a short T: the
    chunked scan is held above)."""
    cfg = TC.get_smoke(arch)
    tree = numpy_params(JC.get_smoke(arch))
    batch = make_batch(cfg, b, min(t, 16))
    loss = {}
    for bf16 in (False, True):
        built = build_train_step(cfg, microbatches=1, bf16_compute=bf16,
                                 device="cpu")
        params = params_from_numpy(tree, device="cpu")
        params, _, m = built.fn(params, built.meta["optimizer"].init(params),
                                batch)
        loss[bf16] = float(m["loss"])
        assert all(p.dtype == torch.float32 and torch.isfinite(p).all()
                   for p in tree_leaves(params))
    assert abs(loss[True] - loss[False]) <= BF16_RTOL * abs(loss[False])


def test_train_quantize_serve():
    """Train, quantize, serve (the reference's
    ``tests/test_system.py:19-55``): the loss falls over 25 steps, the
    trained tree quantizes and the engine serves it, and the quantized
    model's logits are finite."""
    cfg = TC.get_smoke("tinymistral_248m")
    params = tlm.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    opt = AdamW(learning_rate=2e-3)
    opt_state = opt.init(params)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=32,
                                  global_batch=8))
    losses = []
    for _ in range(25):
        batch = data.next_batch()
        fp = tree_map(lambda p: p.detach().requires_grad_(), params)
        loss, _ = tlm.loss_fn(fp, batch, cfg, device="cpu")
        grads = torch.autograd.grad(loss, tree_leaves(fp))
        upd, opt_state, _ = opt.update(tree_unflatten(params, grads),
                                       opt_state, params)
        params = opt.apply(params, upd)
        losses.append(float(loss.detach()))
    assert losses[-1] < losses[0], "training must reduce loss"
    assert not any(p.requires_grad for p in tree_leaves(params))

    eng = Engine(params, cfg, EngineConfig(batch_size=4, cache_len=64,
                                           group_size=32, quant_kv=True),
                 device="cpu")
    for i in range(4):
        eng.submit([i + 1, 5, 9], max_new_tokens=5)
    done = eng.run()
    assert len(done) == 4 and all(len(c.tokens) == 5 for c in done)
    lq, _ = tlm.prefill(eng.params, [[1, 5, 9]], cfg, cache_len=16,
                        device="cpu")
    assert np.isfinite(lq.numpy()).all()
    # the trained tree round-trips through numpy and quantizes alike
    again = params_from_numpy(params_to_numpy(params), device="cpu")
    q0, _, _ = quantize_params(params, QuantPolicy(bits=4, group_size=32))
    q1, _, _ = quantize_params(again, QuantPolicy(bits=4, group_size=32))
    for a, b in zip(tree_leaves(q0), tree_leaves(q1)):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)


def test_launcher_trains_and_resumes(tmp_path, capsys):
    ckpt = str(tmp_path / "ckpt")
    args = ["--arch", "llama3_2_1b", "--smoke", "--steps", "4",
            "--device", "cpu", "--ckpt", ckpt, "--global-batch", "4",
            "--seq", "32"]
    ttrain.main(args)
    out = capsys.readouterr().out
    assert "finished at step 4 (preempted=False)" in out
    assert "resumed" not in out
    assert os.path.isdir(os.path.join(ckpt, "step_00000004"))
    ttrain.main(args[:4] + ["6"] + args[5:])
    out = capsys.readouterr().out
    assert "resumed from step 4" in out
    assert "finished at step 6 (preempted=False)" in out


def test_launcher_asks_for_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrain.main(["--arch", "llama3_2_1b", "--smoke", "--steps", "1"])
