"""KV-cache pricing (port of the three pool-pricing functions of
``repro.planning.cost``): what one cached token and one paged block cost
in bytes, and how many blocks a byte budget buys.  The rest of the
reference module (the decode cost model) waits for the planning slice
(ROADMAP)."""
from __future__ import annotations


def kv_token_bytes(n_layers: int, n_kv: int, head_dim: int,
                   kv_bits: int = 32) -> int:
    """Bytes one cached token costs across all layers (K and V).

    ``kv_bits=8`` prices the served int8 layout: one int8 code per element
    plus one f32 absmax scale per (token, kv-head) for each of K and V —
    the exact tensors ``lm.init_paged_cache(quant_kv=True)`` allocates.
    """
    if kv_bits == 8:
        per_side = n_kv * head_dim + n_kv * 4  # int8 codes + f32 scales
    elif kv_bits == 32:
        per_side = n_kv * head_dim * 4
    else:
        raise ValueError(f"kv_bits must be 8 or 32, got {kv_bits}")
    return 2 * n_layers * per_side


def kv_block_bytes(block_size: int, n_layers: int, n_kv: int, head_dim: int,
                   kv_bits: int = 32) -> int:
    """Bytes of one paged KV block (``block_size`` tokens)."""
    return block_size * kv_token_bytes(n_layers, n_kv, head_dim, kv_bits)


def kv_pool_blocks(budget_bytes: int, block_size: int, n_layers: int,
                   n_kv: int, head_dim: int, kv_bits: int = 32) -> int:
    """Paged blocks a KV byte budget buys: at ``kv_bits=8`` the same budget
    holds ~4x the tokens (minus the scale overhead), so admission sustains
    more users."""
    blk = kv_block_bytes(block_size, n_layers, n_kv, head_dim, kv_bits)
    return max(1, int(budget_bytes) // blk)
