"""Llama-2-7B [arXiv:2307.09288] — the paper's primary evaluation model."""
from repro_torch.models.common import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="llama2-7b", family="dense", vocab=32000, d_model=4096,
        n_layers=32, n_heads=32, n_kv=32, d_ff=11008, act="swiglu",
        norm="rmsnorm", pos="rope", max_seq=4096)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="llama2-7b-smoke", family="dense", vocab=256, d_model=64,
        n_layers=2, n_heads=4, n_kv=4, d_ff=128, act="swiglu",
        attn_chunk=32, max_seq=512)
