"""granite-34b — deep dense code LM with MQA.

[arXiv:2405.04324; hf] 88L d_model=6144 48H (GQA kv=1) d_ff=24576
vocab=49152 — llama-arch, code.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="granite-34b",
    family="dense",
    n_layers=88,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24576,
    vocab=49152,
    rope_theta=1e4,
    supports_long_context=False,
    source="arXiv:2405.04324; hf",
    notes="88-layer MQA code model",
)
