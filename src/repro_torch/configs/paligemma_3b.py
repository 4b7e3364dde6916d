"""paligemma-3b — VLM: SigLIP frontend (stub) + gemma decoder.

[arXiv:2407.07726; hf] 18L d_model=2048 8H (GQA kv=1) d_ff=16384
vocab=257216.  The SigLIP tower is a STUB per assignment: input_specs()
provides 256 precomputed patch embeddings (dim 1152) which are linearly
projected and prepended; prefix tokens attend bidirectionally (PaliGemma's
prefix-LM masking), suffix is causal.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="paligemma-3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab=257216,
    n_prefix_tokens=256,
    prefix_dim=1152,       # SigLIP-So400m width
    rope_theta=1e4,
    tie_embeddings=True,
    supports_long_context=False,
    source="arXiv:2407.07726; hf",
    notes="prefix-LM masking over 256 stub patch embeddings",
)
