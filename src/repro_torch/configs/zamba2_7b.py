"""zamba2-7b — hybrid: Mamba2 backbone + shared attention block.

[arXiv:2411.15242; unverified] 81L d_model=3584 32H (GQA kv=32) d_ff=14336
vocab=32000, ssm_state=64.  The backbone is 81 Mamba2 blocks; a single
*weight-shared* attention+MLP block is interleaved every
`shared_attn_period` blocks (Zamba2's shared-block design).  SSM state is
O(1) in sequence -> long_500k runs (only the shared attn block keeps a KV).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,            # MLP of the shared attention block
    vocab=32000,
    mixer="mamba",
    shared_attn_period=6,  # shared block after every 6 mamba blocks
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    conv_width=4,
    supports_long_context=True,
    source="arXiv:2411.15242; unverified",
    notes="Mamba2 x81 + one weight-shared attn/MLP block invoked periodically",
)
