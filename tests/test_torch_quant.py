"""The port's quantization and Algorithm-1 typeconv against the JAX
reference: the same inputs, made with numpy, must give bit-equal packed
words, codes, scales, codebooks and floats."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jq
from repro.core import typeconv as jtc
from repro_torch.core import quant as tq
from repro_torch.core import typeconv as ttc
from repro_torch.kernels.typeconv import ops as tc_ops


def _bits32(packed) -> np.ndarray:
    return np.asarray(packed).view(np.int32)


@pytest.mark.parametrize("bits", tq.KERNEL_BITS)
@pytest.mark.parametrize("group", [32, 64, 128])
def test_quantize_bit_equal(bits, group):
    rng = np.random.default_rng(100 * bits + group)
    w = rng.standard_normal((3 * group, 45)).astype(np.float32)
    w[:group, 7] = 0.0                       # an all-zero group: scale 1
    ref = jq.quantize(jnp.asarray(w), bits, group)
    got = tq.quantize(torch.from_numpy(w), bits, group)
    np.testing.assert_array_equal(_bits32(ref.packed), got.packed.numpy())
    np.testing.assert_array_equal(np.asarray(ref.scales), got.scales.numpy())
    np.testing.assert_array_equal(np.asarray(ref.codebook),
                                  got.codebook.numpy())
    k = w.shape[0]
    np.testing.assert_array_equal(
        np.asarray(jq.unpack_grouped(ref.packed, bits, group, k)),
        tq.unpack_grouped(got.packed, bits, group, k).numpy())
    np.testing.assert_array_equal(np.asarray(jq.dequantize(ref)),
                                  tq.dequantize(got).numpy())
    assert got.nbytes() == ref.nbytes()


@pytest.mark.parametrize("bits", tq.KERNEL_BITS)
def test_pack_grouped_bit_equal(bits):
    rng = np.random.default_rng(bits)
    codes = rng.integers(0, 1 << bits, size=(96, 5, 3))
    ref = jq.pack_grouped(jnp.asarray(codes, jnp.uint32), bits, 32)
    got = tq.pack_grouped(torch.from_numpy(codes), bits, 32)
    np.testing.assert_array_equal(_bits32(ref), got.numpy())
    np.testing.assert_array_equal(
        tq.unpack_grouped(got, bits, 32, 96).numpy(), codes)
    assert tq.words_per_group(bits, 32) == jq.words_per_group(bits, 32)


@pytest.mark.parametrize("bits", [2, 3, 4, 8])
def test_nf_codebook_quantize_bit_equal(bits):
    np.testing.assert_array_equal(np.asarray(jq.nf_codebook(bits)),
                                  tq.nf_codebook(bits).numpy())
    rng = np.random.default_rng(bits)
    w = rng.standard_normal((128, 33)).astype(np.float32)
    ref = jq.quantize(jnp.asarray(w), bits, 64, codebook=jq.nf_codebook(bits))
    got = tq.quantize(torch.from_numpy(w), bits, 64,
                      codebook=tq.nf_codebook(bits))
    np.testing.assert_array_equal(_bits32(ref.packed), got.packed.numpy())
    np.testing.assert_array_equal(np.asarray(jq.dequantize(ref)),
                                  tq.dequantize(got).numpy())


@pytest.mark.parametrize("abits", tq.SUPPORTED_ABITS)
def test_quantize_activations_bit_equal(abits):
    rng = np.random.default_rng(abits)
    x = rng.standard_normal((6, 200)).astype(np.float32)
    x[2] = 0.0
    xq_ref, s_ref = jq.quantize_activations(jnp.asarray(x), abits)
    xq, s = tq.quantize_activations(torch.from_numpy(x), abits)
    assert xq.dtype == torch.int32 and s.shape == (6, 1)
    np.testing.assert_array_equal(np.asarray(xq_ref), xq.numpy())
    np.testing.assert_array_equal(np.asarray(s_ref), s.numpy())


def test_quantize_kv_bit_equal():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    x[1, 2, 0] = 0.0
    c_ref, s_ref = jq.quantize_kv(jnp.asarray(x))
    c, s = tq.quantize_kv(torch.from_numpy(x))
    assert c.dtype == torch.int8
    np.testing.assert_array_equal(np.asarray(c_ref), c.numpy())
    np.testing.assert_array_equal(np.asarray(s_ref), s.numpy())
    np.testing.assert_array_equal(np.asarray(jq.dequantize_kv(c_ref, s_ref)),
                                  tq.dequantize_kv(c, s).numpy())


@pytest.mark.parametrize("n", [2, 3, 8, 16, 25])
def test_algorithm1_bit_equal_to_reference_and_cast(n):
    lim = 1 << (n - 1)
    rng = np.random.default_rng(n)
    a = rng.integers(-lim + 1, lim, size=777).astype(np.int32)
    a[:3] = [0, lim - 1, -(lim - 1)]
    got = ttc.int_to_f32(torch.from_numpy(a), n)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), a.astype(np.float32))
    np.testing.assert_array_equal(
        got.numpy().view(np.int32),
        np.asarray(jtc.int_to_f32(jnp.asarray(a), n)).view(np.int32))
    # the kernel wrapper takes the plain version for a CPU tensor
    np.testing.assert_array_equal(
        tc_ops.int_to_f32(torch.from_numpy(a).reshape(7, 111), n).numpy(),
        a.astype(np.float32).reshape(7, 111))


def test_typeconv_helpers_match_reference():
    x = np.array([-3.5, -2.5, 0.5, 1.5, 2.49, 1e9], np.float32)
    for n in (8, 25):
        np.testing.assert_array_equal(
            np.asarray(jtc.f32_to_int(jnp.asarray(x), n)),
            ttc.f32_to_int(torch.from_numpy(x), n).numpy())
    for n in (4, 8, 16, 25):
        assert ttc.logic_ops(n) == jtc.logic_ops(n)
        assert ttc.sram_cycles(n) == jtc.sram_cycles(n)
    with pytest.raises(ValueError):
        ttc.int_to_f32(torch.zeros(3, dtype=torch.int32), 26)
