"""Llama-2-13B [arXiv:2307.09288] — the paper's larger evaluation model."""
from repro_torch.models.common import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="llama2-13b", family="dense", vocab=32000, d_model=5120,
        n_layers=40, n_heads=40, n_kv=40, d_ff=13824, act="swiglu",
        norm="rmsnorm", pos="rope", max_seq=4096)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="llama2-13b-smoke", family="dense", vocab=256, d_model=80,
        n_layers=2, n_heads=4, n_kv=4, d_ff=160, act="swiglu",
        attn_chunk=32, max_seq=512)
