"""TinyMistral-248M [hf:Locutusque/TinyMistral-248M] — the paper's small
evaluation model (mistral family: GQA, SWA)."""
from repro_torch.models.common import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="tinymistral-248m", family="dense", vocab=32005, d_model=1024,
        n_layers=12, n_heads=32, n_kv=8, d_ff=4096, act="swiglu",
        norm="rmsnorm", pos="rope", window=4096, max_seq=32768)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="tinymistral-248m-smoke", family="dense", vocab=256,
        d_model=64, n_layers=2, n_heads=8, n_kv=2, d_ff=128, act="swiglu",
        window=64, attn_chunk=32, max_seq=512)
