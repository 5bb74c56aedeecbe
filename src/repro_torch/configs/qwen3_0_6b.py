"""Qwen3-0.6B [hf:Qwen/Qwen3-0.6B]: GQA kv=8 with explicit head_dim=128
and qk-norm, SwiGLU, RMSNorm, tied embeddings."""
from repro_torch.models.common import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen3-0.6b", family="dense", vocab=151936, d_model=1024,
        n_layers=28, n_heads=16, n_kv=8, d_head=128, d_ff=3072,
        act="swiglu", norm="rmsnorm", pos="rope", rope_theta=1e6,
        qk_norm=True, tie_embeddings=True, max_seq=1048576)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen3-0.6b-smoke", family="dense", vocab=256, d_model=64,
        n_layers=2, n_heads=4, n_kv=2, d_head=32, d_ff=128, act="swiglu",
        qk_norm=True, tie_embeddings=True, attn_chunk=32, max_seq=512)
