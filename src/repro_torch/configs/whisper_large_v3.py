"""Whisper-large-v3 [arXiv:2212.04356]: encoder-decoder, MHA (kv=20),
GELU, LayerNorm, attention biases; conv audio frontend is a stub
(the caller provides frame embeddings)."""
from repro_torch.models.common import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="whisper-large-v3", family="encdec", vocab=51866, d_model=1280,
        n_layers=32, n_enc_layers=32, n_heads=20, n_kv=20, d_ff=5120,
        act="gelu", norm="layernorm", pos="sinusoidal",
        attention_bias=True, enc_seq=1500, frontend="audio", max_seq=65536)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="whisper-large-v3-smoke", family="encdec", vocab=256,
        d_model=64, n_layers=2, n_enc_layers=2, n_heads=4, n_kv=4, d_ff=128,
        act="gelu", norm="layernorm", pos="sinusoidal", attention_bias=True,
        enc_seq=32, frontend="audio", attn_chunk=32, max_seq=512)
