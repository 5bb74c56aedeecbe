"""The training losses' attention, ``layers.chunked_attention``, against
the reference's chunked ``layers.flash_attention`` called with small
``chunk`` / ``q_chunk``: values, and ``jax.grad`` against autograd, within
2e-5, on every branch (key chunks only, query blocks, the largest-divisor
block, the windowed band, bidirectional, a partly padded last chunk); and
the serving paths, which keep the one-pass form bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro_torch.configs as TC
from repro.models import layers as jlayers
from repro_torch.convert import params_from_numpy
from repro_torch.models import encdec as tencdec
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm

from _torch_models import numpy_params

TOL = 2e-5

# name: (T, S, H, KV, Dh, causal, window, chunk, q_chunk)
CASES = {
    "kv_chunks_only": (64, 64, 4, 2, 8, True, None, 16, 512),
    "window_no_band": (64, 64, 4, 2, 8, True, 24, 16, 512),
    "query_blocks": (128, 128, 4, 2, 8, True, None, 16, 32),
    "largest_divisor": (100, 100, 4, 2, 8, True, None, 16, 32),
    "windowed_band": (256, 256, 4, 2, 8, True, 32, 16, 32),
    "bidirectional": (48, 48, 4, 1, 8, False, None, 16, 512),
    "cross_blocks": (96, 40, 6, 3, 8, False, None, 16, 32),
    "padded_last_chunk": (40, 40, 4, 2, 8, True, None, 16, 512),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def inputs(t, s, h, kv, dh, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((2, t, h, dh)).astype(np.float32)
    k = rng.standard_normal((2, s, kv, dh)).astype(np.float32)
    v = rng.standard_normal((2, s, kv, dh)).astype(np.float32)
    w = rng.standard_normal((2, t, h, dh)).astype(np.float32)
    return q, k, v, w


def assert_close(got, want, tol=TOL):
    want = np.asarray(want)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), err


class Counter:
    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *args, **kw):
        self.calls += 1
        return self.fn(*args, **kw)


@pytest.mark.parametrize("case", list(CASES))
def test_chunked_attention_matches_reference(case, monkeypatch):
    t, s, h, kv, dh, causal, window, chunk, q_chunk = CASES[case]
    q, k, v, w = inputs(t, s, h, kv, dh)
    kw = dict(causal=causal, window=window, chunk=chunk, q_chunk=q_chunk)

    def j_loss(q_, k_, v_):
        return jnp.sum(jlayers.flash_attention(q_, k_, v_, **kw) * w)

    want = jlayers.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), **kw)
    jgrads = jax.grad(j_loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))

    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    got = tlayers.chunked_attention(tq, tk, tv, **kw)
    assert_close(got.detach().numpy(), want)
    grads = torch.autograd.grad(torch.sum(got * torch.from_numpy(w)),
                                [tq, tk, tv])
    for g, jg in zip(grads, jgrads):
        assert_close(g.numpy(), jg)
    # the one-pass form computes the same function (self-attention from
    # position 0)
    if t == s:
        one = tlayers.flash_attention(torch.from_numpy(q),
                                      torch.from_numpy(k),
                                      torch.from_numpy(v), window=window,
                                      causal=causal)
        assert_close(one.numpy(), want)


def test_query_blocks_and_chunks_run_under_checkpoint(monkeypatch):
    """T 128 in 4 blocks of 32 and keys in chunks of 16, causal: 4 block
    checkpoints (``torch.utils.checkpoint``) and 2 + 4 + 6 + 8 chunk
    checkpoints (``_ChunkStep``) in the forward pass (a chunk past the
    block's last query is skipped), whose backward passes recompute the
    blocks' 20 chunk steps; no checkpoint without grad, and the same
    values."""
    q, k, v, w = inputs(128, 128, 4, 2, 8)
    blocks = Counter(tlayers.checkpoint)
    chunks = Counter(tlayers._ChunkStep.apply)
    steps = Counter(tlayers._online_step)
    monkeypatch.setattr(tlayers, "checkpoint", blocks)
    monkeypatch.setattr(tlayers._ChunkStep, "apply", chunks)
    monkeypatch.setattr(tlayers, "_online_step", steps)
    kw = dict(causal=True, window=None, chunk=16, q_chunk=32)
    plain = tlayers.chunked_attention(*(torch.from_numpy(a)
                                        for a in (q, k, v)), **kw)
    assert (blocks.calls, chunks.calls, steps.calls) == (0, 0, 20)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = tlayers.chunked_attention(*leaves, **kw)
    assert (blocks.calls, chunks.calls, steps.calls) == (4, 20, 40)
    assert torch.equal(out.detach(), plain)
    torch.autograd.grad(torch.sum(out * torch.from_numpy(w)), leaves)
    assert (blocks.calls, chunks.calls, steps.calls) == (4, 40, 60)


def test_bf16_inputs_give_bf16_output():
    """Under bf16 compute q, k, v arrive in bf16: the softmax runs in f32
    and the output is cast back, as the reference's is."""
    q, k, v, _ = inputs(64, 64, 4, 2, 8)
    kw = dict(causal=True, window=None, chunk=16, q_chunk=32)
    want = jlayers.flash_attention(*(jnp.asarray(a, jnp.bfloat16)
                                     for a in (q, k, v)), **kw)
    got = tlayers.chunked_attention(*(torch.from_numpy(a).to(torch.bfloat16)
                                      for a in (q, k, v)), **kw)
    assert got.dtype == torch.bfloat16
    assert_close(got.float().numpy(), np.asarray(want, np.float32),
                 tol=1e-2)


# --- serving keeps the one-pass form ------------------------------------

def seed_one_pass(q, k, v, *, window, causal=True):
    """The one-pass attention as the serving prefills ran it before the
    chunked form was added, line for line."""
    import math
    b, t, h, dh = q.shape
    s, kv = k.shape[1], k.shape[2]
    g = h // kv
    qg = q.reshape(b, t, kv, g, dh).to(torch.float32)
    scores = torch.einsum("btghd,bsgd->btghs", qg,
                          k.to(torch.float32)) * (1.0 / math.sqrt(dh))
    q_pos = torch.arange(t, device=q.device)[:, None]
    kv_pos = torch.arange(s, device=q.device)[None, :]
    valid = (kv_pos <= q_pos if causal
             else torch.ones((t, s), dtype=torch.bool, device=q.device))
    if window is not None:
        valid &= kv_pos > q_pos - window
    valid = valid[None, :, None, None, :]
    scores = scores.masked_fill(~valid, float("-inf"))
    m = scores.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(scores - m).masked_fill(~valid, 0.0)
    acc = torch.einsum("btghs,bsgd->btghd", p, v.to(torch.float32))
    out = acc / torch.clamp(p.sum(-1), min=1e-30)[..., None]
    return out.reshape(b, t, h, dh).to(q.dtype)


def refuse(*args, **kw):
    raise AssertionError("a serving path took the chunked attention")


def serve_all(arch):
    """Every serving prefill of ``arch`` (smoke, seed-0 numpy weights) on
    one prompt set past the window: lm.prefill, prefill_into_slot and
    prefill_into_blocks, or whisper's serve_prefill."""
    cfg = TC.get_smoke(arch)
    params = params_from_numpy(numpy_params(JC.get_smoke(arch)),
                               device="cpu")
    rng = np.random.default_rng(3)
    if cfg.family == "encdec":
        frames = rng.standard_normal((2, cfg.enc_seq, cfg.d_model)).astype(
            np.float32)
        cache = tencdec.serve_prefill(params, frames, cfg, 16, device="cpu")
        return [cache["layers"]["ck"], cache["layers"]["cv"]]
    toks = rng.integers(0, cfg.vocab, (2, 80)).astype(np.int32)
    logits, cache = tlm.prefill(params, toks, cfg, cache_len=128,
                                device="cpu")
    out = [logits, cache["layers"]["k"], cache["layers"]["v"]]
    pool = tlm.init_cache(cfg, 2, 128, device="cpu")
    out.append(tlm.prefill_into_slot(params, toks[:1], pool, 1, cfg,
                                     device="cpu")[0])
    paged = tlm.init_paged_cache(cfg, 2, 16, 8, device="cpu")
    rows = torch.arange(80)
    logits, paged = tlm.prefill_into_blocks(params, toks[:1], paged, [0],
                                            rows // 8, rows % 8, cfg,
                                            device="cpu")
    return out + [logits, paged["layers"]["k"]]


@pytest.mark.parametrize("arch", ["tinymistral_248m", "whisper_large_v3"])
def test_serving_prefills_keep_the_one_pass_form(arch, monkeypatch):
    """The prefills never reach ``chunked_attention``, and their outputs
    equal bit for bit those of the one-pass attention as it stood before
    the chunked form was added."""
    now = serve_all(arch)
    monkeypatch.setattr(tlayers, "chunked_attention", refuse)
    monkeypatch.setattr(tlayers, "flash_attention", seed_one_pass)
    before = serve_all(arch)
    assert len(now) == len(before)
    for a, b in zip(now, before):
        assert torch.equal(a, b)
