"""StarCoder2-7B [arXiv:2402.19173]: dense GQA, RoPE, GELU, LayerNorm,
attention+MLP biases.  36 heads x 128 = 4608; kv=4."""
from repro_torch.models.common import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-7b", family="dense", vocab=49152, d_model=4608,
        n_layers=32, n_heads=36, n_kv=4, d_ff=18432, act="gelu",
        norm="layernorm", pos="rope", rope_theta=1e5,
        attention_bias=True, mlp_bias=False, max_seq=1048576)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-7b-smoke", family="dense", vocab=256, d_model=72,
        n_layers=2, n_heads=6, n_kv=2, d_ff=144, act="gelu",
        norm="layernorm", pos="rope", attention_bias=True,
        attn_chunk=32, max_seq=512)
