"""Mixtral-8x7B [arXiv:2401.04088]: 8 experts top-2, GQA kv=8, SWA 4096
(-> runs long_500k).  Experts shard FFN-dim over the model axis
(8 experts < 16-way axis)."""
from repro_torch.models.common import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x7b", family="moe", vocab=32000, d_model=4096,
        n_layers=32, n_heads=32, n_kv=8, d_ff=14336, act="swiglu",
        norm="rmsnorm", pos="rope", rope_theta=1e6, n_experts=8, top_k=2,
        moe_ffn=14336, moe_shard="ffn", window=4096, max_seq=1048576)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x7b-smoke", family="moe", vocab=256, d_model=64,
        n_layers=2, n_heads=4, n_kv=2, d_ff=128, act="swiglu", n_experts=4,
        top_k=2, moe_ffn=128, moe_shard="ffn", window=64, attn_chunk=32,
        max_seq=512)
