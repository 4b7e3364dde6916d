"""mamba2-370m — attention-free SSM (state-space duality).

[arXiv:2405.21060; unverified] 48L d_model=1024 d_ff=0 vocab=50280,
ssm_state=128.  No attention, no MLP block (Mamba2 blocks only, d_ff=0);
decode state is O(1) in sequence length -> runs long_500k.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=32,            # SSD heads = d_inner / ssm_head_dim = 2048/64
    n_kv_heads=32,
    d_ff=0,                # no MLP block
    vocab=50280,
    mixer="mamba",
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    conv_width=4,
    supports_long_context=True,
    source="arXiv:2405.21060; unverified",
    notes="SSD (state-space duality); pure Mamba2 stack",
)
