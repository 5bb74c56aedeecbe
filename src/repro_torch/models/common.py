"""Model configuration (a copy of ``repro.models.common``).

One dataclass parameterizes every family the reference serves; the port
so far runs the dense family.  ``src/repro_torch/configs/<arch>.py``
instantiates the exact published dimensions plus a ``smoke()``
reduction for CPU tests.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"          # dense | moe | hybrid | ssm | encdec
    vocab: int = 32000
    d_model: int = 1024
    n_layers: int = 12
    n_heads: int = 16
    n_kv: int = 8
    d_head: Optional[int] = None   # default d_model // n_heads
    d_ff: int = 4096
    act: str = "swiglu"            # swiglu | gelu | geglu
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    norm_eps: float = 1e-5
    pos: str = "rope"              # rope | learned | sinusoidal | none
    rope_theta: float = 10000.0
    qk_norm: bool = False          # qwen3
    window: Optional[int] = None   # SWA width (danube, mixtral, hymba attn)
    attention_bias: bool = False
    mlp_bias: bool = False
    tie_embeddings: bool = False
    max_seq: int = 131072
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    moe_ffn: Optional[int] = None  # per-expert hidden dim (defaults d_ff)
    moe_shard: str = "expert"      # expert (EP) | ffn (TP inside expert)
    capacity_factor: float = 1.25
    # --- SSM / hybrid ---
    ssm_state: int = 16
    ssm_conv: int = 4
    ssm_expand: float = 2.0
    hybrid_ratio: float = 0.5      # fraction of width given to mamba branch
    # --- xLSTM ---
    slstm_every: int = 4           # every Nth block is sLSTM (else mLSTM)
    # --- enc-dec (whisper) ---
    n_enc_layers: int = 0
    enc_seq: int = 1500            # audio frame embeddings after conv stub
    # --- frontends (stubs; see DESIGN.md) ---
    frontend: Optional[str] = None  # "audio" | "vision"
    vision_tokens: int = 576       # CLIP-ViT-L/14 @336: (336/14)^2 patches
    # --- numerics ---
    dtype: str = "float32"
    remat: bool = True
    attn_chunk: int = 512          # flash-attention KV block in pure JAX

    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head is not None else (
            self.d_model // self.n_heads)

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv * self.head_dim

    @property
    def expert_ffn(self) -> int:
        return self.moe_ffn if self.moe_ffn is not None else self.d_ff

    def param_count(self) -> int:
        """Analytic parameter count (used for 6*N*D MODEL_FLOPS)."""
        d, f = self.d_model, self.d_ff
        attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        if self.family == "ssm":  # xlstm
            inner = int(self.ssm_expand * d)
            per = 2 * d * 2 * inner + 2 * inner * d  # qkv-ish proj + out
            blocks = self.n_layers * per
        elif self.family == "hybrid":
            inner = int(self.ssm_expand * d * self.hybrid_ratio)
            mamba = 2 * d * inner + inner * self.ssm_state * 2 + inner * d
            mlp = 3 * d * f if self.act in ("swiglu", "geglu") else 2 * d * f
            blocks = self.n_layers * (attn + mamba + mlp)
        elif self.family == "moe":
            e = self.n_experts * (3 * d * self.expert_ffn
                                  if self.act in ("swiglu", "geglu")
                                  else 2 * d * self.expert_ffn)
            router = d * self.n_experts
            blocks = self.n_layers * (attn + e + router)
        else:
            mlp = 3 * d * f if self.act in ("swiglu", "geglu") else 2 * d * f
            blocks = self.n_layers * (attn + mlp)
            if self.family == "encdec":
                blocks += self.n_enc_layers * (attn + mlp) + \
                    self.n_layers * attn  # cross attention
        embed = self.vocab * d * (1 if self.tie_embeddings else 2)
        return blocks + embed

    def active_param_count(self) -> int:
        """Active (per-token) params — MoE uses top_k of n_experts."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        e_all = self.n_experts * 3 * d * self.expert_ffn
        e_act = self.top_k * 3 * d * self.expert_ffn
        return self.param_count() - self.n_layers * (e_all - e_act)
