"""Granite-3.0-1B-A400M [hf:ibm-granite/granite-3.0-1b-a400m-base]:
MoE with 32 experts, top-8, per-expert ffn 512, tied embeddings."""
from repro_torch.models.common import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-1b-a400m", family="moe", vocab=49155,
        d_model=1024, n_layers=24, n_heads=16, n_kv=8, d_ff=512,
        act="swiglu", norm="rmsnorm", pos="rope", n_experts=32, top_k=8,
        moe_ffn=512, moe_shard="expert", tie_embeddings=True,
        max_seq=131072)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-smoke", family="moe", vocab=256, d_model=64,
        n_layers=2, n_heads=4, n_kv=2, d_ff=64, act="swiglu", n_experts=4,
        top_k=2, moe_ffn=64, moe_shard="expert", tie_embeddings=True,
        attn_chunk=32, max_seq=512)
