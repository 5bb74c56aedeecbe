"""Hymba-1.5B [arXiv:2411.13676]: hybrid-head blocks running attention and
mamba heads in parallel; SWA on attention heads + O(1) SSM state ->
runs long_500k.  25 heads x 64 = 1600; kv=5."""
from repro_torch.models.common import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="hymba-1.5b", family="hybrid", vocab=32001, d_model=1600,
        n_layers=32, n_heads=25, n_kv=5, d_ff=5504, act="swiglu",
        norm="rmsnorm", pos="rope", window=1024, ssm_state=16,
        ssm_expand=2.0, hybrid_ratio=0.5, max_seq=1048576)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="hymba-1.5b-smoke", family="hybrid", vocab=256, d_model=64,
        n_layers=2, n_heads=4, n_kv=2, d_ff=128, act="swiglu", window=32,
        ssm_state=4, ssm_expand=2.0, hybrid_ratio=0.5, attn_chunk=32,
        max_seq=512)
