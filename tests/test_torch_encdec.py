"""The port's whisper (``models/encdec.py``) and phi-3-vision's prefix
embeddings against the JAX reference on the CPU, weights and inputs from
a numpy seed (``tests/_torch_models.py``: nonzero attention and LayerNorm
biases).  ``sinusoidal_positions``; the encoder, the cross K/V of
``serve_prefill``, 4 ``serve_decode_step`` calls and the teacher-forced
decoder, with the biases where the reference adds them and nowhere else;
the cross-attention's plain path against the reference's einsum softmax;
the quantized path set at the published width; phi-3-vision smoke
``prefill(prefix_embeds=...)`` and decode steps."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro_torch.configs as TC
from _torch_models import (both, one_torch_thread,  # noqa: F401
                           quantized_paths_full)
from repro.models import encdec as jed
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro_torch.models import encdec as ted
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm
from repro_torch.models.sail_linear import _walk

ARCH = "whisper_large_v3"
TOL = dict(rtol=1e-4, atol=1e-4)
ATTN_TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = JC.get_smoke(ARCH), TC.get_smoke(ARCH)
    frames = np.random.default_rng(3).standard_normal(
        (2, jcfg.enc_seq, jcfg.d_model)).astype(np.float32)
    return (jcfg, tcfg) + both(jcfg, seed=5) + (frames,)


@pytest.mark.parametrize("seq,d", [(512, 64), (1500, 1280)])
def test_sinusoidal_positions(seq, d):
    """The angles ``pos / 10000 ** (dim / d)`` are the reference's bit for
    bit; sin and cos are correctly rounded, within one ulp of the
    reference's f32 ones (which part from correct rounding on ~1% of
    entries); a row computed alone is the table's row bit for bit."""
    pos = jnp.arange(seq, dtype=jnp.float32)[:, None]
    dim = jnp.arange(0, d, 2, dtype=jnp.float32)[None, :]
    want_ang = np.asarray(pos / (10000.0 ** (dim / d)))
    got_ang = tlayers.sinusoidal_angles(torch.arange(seq), d).numpy()
    np.testing.assert_array_equal(got_ang, want_ang)
    want = np.asarray(jlayers.sinusoidal_positions(seq, d))
    got = tlayers.sinusoidal_positions(seq, d).numpy()
    exact = np.sin(want_ang.astype(np.float64)), np.cos(
        want_ang.astype(np.float64))
    np.testing.assert_array_equal(got[:, 0::2], exact[0].astype(np.float32))
    np.testing.assert_array_equal(got[:, 1::2], exact[1].astype(np.float32))
    ulp = np.spacing(np.maximum(np.abs(want), np.abs(got)))
    assert bool((np.abs(got - want) <= ulp).all())
    rows = torch.tensor([0, 1, seq // 3, seq - 1])
    assert torch.equal(tlayers.sinusoidal_rows(rows, d),
                       torch.from_numpy(got)[rows])


def test_encoder_cross_kv_and_teacher_forced_decoder(model):
    """The bidirectional encoder, every decoder layer's cross K/V (with
    ``bk`` / ``bv``) and the teacher-forced decoder (causal self-attention,
    cross-attention, biases in both) at 1e-4."""
    jcfg, tcfg, jparams, carried, frames = model
    jmem = jed.encode(jparams, jnp.asarray(frames), jcfg)
    tmem = ted.encode(carried, frames, tcfg, device="cpu")
    np.testing.assert_allclose(tmem.numpy(), np.asarray(jmem), **TOL)
    jc = jed.serve_prefill(jparams, jnp.asarray(frames), jcfg, 16)
    tc = ted.serve_prefill(carried, frames, tcfg, 16, device="cpu")
    for name in ("ck", "cv"):
        np.testing.assert_allclose(tc["layers"][name].numpy(),
                                   np.asarray(jc["layers"][name]), **TOL)
    toks = np.random.default_rng(1).integers(0, jcfg.vocab, (2, 7))
    want = jed.decode_forward(jparams, jnp.asarray(toks), jmem, jcfg)
    got = ted.decode_forward(carried, toks, tmem, tcfg, device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _steps(jparams, carried, jcfg, tcfg, frames, quant_kv, steps=4):
    """(reference logits, port logits) of ``steps`` greedy decode steps
    after ``serve_prefill`` (the reference's tokens fed to both)."""
    jc = jed.serve_prefill(jparams, jnp.asarray(frames), jcfg, 16, quant_kv)
    tc = ted.serve_prefill(carried, frames, tcfg, 16, quant_kv, device="cpu")
    tok = np.array([[1], [2]])
    js, ts = [], []
    for _ in range(steps):
        jl, jc = jed.serve_decode_step(jparams, jnp.asarray(tok), jc, jcfg,
                                       quant_kv)
        tl, tc = ted.serve_decode_step(carried, tok, tc, tcfg, quant_kv,
                                       device="cpu")
        js.append(np.asarray(jl))
        ts.append(tl.numpy())
        tok = np.argmax(js[-1], -1)[:, None]
    assert tc["length"].tolist() == [steps, steps]
    return np.stack(js), np.stack(ts)


@pytest.mark.parametrize("quant_kv", [False, True])
def test_serve_decode_steps_match(model, quant_kv):
    """4 decode steps over the self-attention ring (f32 or int8) and the
    cross K/V: logits at 1e-4.  The biases are nonzero, and the step uses
    exactly the reference's: zeroing the self-attention's ``bq bk bv bo``
    and the cross ``bq`` / ``bo`` leaves the logits bit-equal, zeroing the
    cross ``bk`` / ``bv`` (added in ``_cross_kv``) moves them."""
    jcfg, tcfg, jparams, carried, frames = model
    want, got = _steps(jparams, carried, jcfg, tcfg, frames, quant_kv)
    np.testing.assert_allclose(got, want, **TOL)
    dec = carried["dec_blocks"]
    assert all(float(dec[a][b].abs().min()) > 0 for a in ("self_attn",
                                                          "cross_attn")
               for b in ("bq", "bk", "bv", "bo"))

    def zeroed(names):
        def leaf(path, x):
            return torch.zeros_like(x) if any(n in path for n in names) else x
        return _walk(carried, leaf)
    unused = zeroed(["['self_attn']['bq']", "['self_attn']['bk']",
                     "['self_attn']['bv']", "['self_attn']['bo']",
                     "['cross_attn']['bq']", "['cross_attn']['bo']"])
    _, same = _steps(jparams, unused, jcfg, tcfg, frames, quant_kv)
    np.testing.assert_array_equal(same, got)
    used = zeroed(["['cross_attn']['bk']", "['cross_attn']['bv']"])
    _, moved = _steps(jparams, used, jcfg, tcfg, frames, quant_kv, steps=1)
    assert np.abs(moved[0] - got[0]).max() > 1e-3


def test_cross_attention_plain_path_matches_reference_einsum(model):
    """The decode step's cross-attention (decode attention's lengths mode
    with every slot valid; its plain version on the CPU) against the
    reference's einsum softmax (``encdec.py:199-207``) at 2e-5."""
    jcfg, tcfg, _, _, _ = model
    rng = np.random.default_rng(7)
    b, s, kv, dh = 3, jcfg.enc_seq, jcfg.n_kv, jcfg.head_dim
    q = rng.standard_normal((b, jcfg.n_heads, dh)).astype(np.float32)
    ck = rng.standard_normal((b, s, kv, dh)).astype(np.float32)
    cv = rng.standard_normal((b, s, kv, dh)).astype(np.float32)
    qg = jnp.asarray(q).reshape(b, kv, jcfg.n_heads // kv, dh)
    scores = jnp.einsum("bghd,bsgd->bghs", qg, jnp.asarray(ck))
    scores = scores / jnp.sqrt(dh).astype(jnp.float32)
    pa = jax.nn.softmax(scores, axis=-1)
    want = jnp.einsum("bghs,bsgd->bghd", pa, jnp.asarray(cv))
    got = ted.cross_attend(torch.from_numpy(q), torch.from_numpy(ck),
                           torch.from_numpy(cv))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(want).reshape(b, -1, dh),
                               **ATTN_TOL)


def test_quantized_paths_match_reference():
    """At whisper's published width (group 128) the encoder's and the
    decoder's ``wq wk wv wo w_up w_down`` and the cross-attention's
    weights are quantized, the embedding and biases are not, as the
    reference's are."""
    want, got = quantized_paths_full(ARCH, 128)
    assert got == want and len(got) == 6 + 10
    assert not any("embed" in p or "['b" in p for p in got)


def test_vision_prefix_prefill_and_decode_match():
    """phi-3-vision smoke: 8 prefix embeddings ahead of 9 prompt tokens
    (ragged lengths 9 and 6), then 4 greedy decode steps; logits at 1e-4
    with f32 KV (an int8 cache rounds K/V values that f32 rounding can put
    on either side of a code boundary), the cache's length counting the
    prefix."""
    arch = "phi_3_vision_4_2b"
    jcfg, tcfg = JC.get_smoke(arch), TC.get_smoke(arch)
    jparams, carried = both(jcfg, seed=6)
    rng = np.random.default_rng(2)
    toks = rng.integers(0, jcfg.vocab, (2, 9))
    lengths = np.array([9, 6], np.int32)
    pe = rng.standard_normal((2, jcfg.vision_tokens, jcfg.d_model)).astype(
        np.float32)
    jl, jc = jlm.prefill(jparams, toks, jcfg, cache_len=32,
                         prefix_embeds=jnp.asarray(pe),
                         lengths=jnp.asarray(lengths))
    tl, tc = tlm.prefill(carried, toks, tcfg, 32, lengths=lengths,
                         device="cpu", prefix_embeds=torch.from_numpy(pe))
    assert tc["length"].tolist() == (lengths + jcfg.vision_tokens).tolist()
    for _ in range(5):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        tok = np.argmax(np.asarray(jl), -1)[:, None]
        jl, jc = jlm.decode_step(jparams, jnp.asarray(tok), jc, jcfg)
        tl, tc = tlm.decode_step(carried, torch.from_numpy(tok), tc, tcfg,
                                 device="cpu")
