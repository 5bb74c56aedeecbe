"""xLSTM-350M [arXiv:2405.04517]: mLSTM blocks with an sLSTM block every
4th layer (scanned as homogeneous super-blocks); O(1) recurrent state ->
runs long_500k."""
from repro_torch.models.common import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="xlstm-350m", family="ssm", vocab=50304, d_model=1024,
        n_layers=24, n_heads=4, n_kv=4, d_ff=0, act="swiglu",
        norm="rmsnorm", pos="none", ssm_expand=2.0, slstm_every=4,
        max_seq=1048576)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="xlstm-350m-smoke", family="ssm", vocab=256, d_model=64,
        n_layers=2, n_heads=2, n_kv=2, d_ff=0, act="swiglu", pos="none",
        ssm_expand=2.0, slstm_every=2, attn_chunk=32, max_seq=512)
