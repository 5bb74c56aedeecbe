"""H2O-Danube3-4B [arXiv:2401.16818 family]: llama+mistral mix with
sliding-window attention (window 4096) -> runs long_500k."""
from repro_torch.models.common import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="h2o-danube-3-4b", family="dense", vocab=32000, d_model=3840,
        n_layers=24, n_heads=32, n_kv=8, d_ff=10240, act="swiglu",
        norm="rmsnorm", pos="rope", rope_theta=1e4, window=4096,
        max_seq=1048576)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="h2o-danube-3-4b-smoke", family="dense", vocab=256, d_model=64,
        n_layers=2, n_heads=4, n_kv=2, d_ff=128, act="swiglu", window=64,
        attn_chunk=32, max_seq=512)
