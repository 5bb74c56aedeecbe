"""Llama-3.2-1B [hf:meta-llama/Llama-3.2-1B]: dense GQA kv=8, SwiGLU,
RMSNorm, RoPE theta 5e5, tied embeddings."""
from repro_torch.models.common import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-1b", family="dense", vocab=128256, d_model=2048,
        n_layers=16, n_heads=32, n_kv=8, d_ff=8192, act="swiglu",
        norm="rmsnorm", pos="rope", rope_theta=5e5, tie_embeddings=True,
        max_seq=1048576)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-1b-smoke", family="dense", vocab=256, d_model=64,
        n_layers=2, n_heads=4, n_kv=2, d_ff=128, act="swiglu",
        tie_embeddings=True, attn_chunk=32, max_seq=512)
