"""Phi-3-vision-128k [hf:microsoft/Phi-3-vision-128k-instruct]: phi3-mini
backbone (MHA kv=32, SwiGLU, RMSNorm) + CLIP-ViT-L/14 frontend stub
(the caller provides 576 patch embeddings at 336px)."""
from repro_torch.models.common import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="phi-3-vision-4.2b", family="dense", vocab=32064, d_model=3072,
        n_layers=32, n_heads=32, n_kv=32, d_ff=8192, act="swiglu",
        norm="rmsnorm", pos="rope", rope_theta=1e4, frontend="vision",
        vision_tokens=576, max_seq=131072)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="phi-3-vision-4.2b-smoke", family="dense", vocab=256,
        d_model=64, n_layers=2, n_heads=4, n_kv=4, d_ff=128, act="swiglu",
        frontend="vision", vision_tokens=8, attn_chunk=32, max_seq=512)
