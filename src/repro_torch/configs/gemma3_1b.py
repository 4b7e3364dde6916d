"""gemma3-1b — dense, 5:1 local:global attention, 128k-ready.

[hf:google/gemma-3-1b-pt; unverified] 26L d_model=1152 4H (GQA kv=1)
d_ff=6912 vocab=262144; head_dim 256; sliding window 512 on local layers,
every 6th layer global.  Local layers keep an O(window) KV -> long_500k runs.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-1b",
    family="dense",
    n_layers=26,
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab=262144,
    sliding_window=512,
    local_global_period=6,   # 5 local : 1 global
    rope_theta=1e6,
    tie_embeddings=True,
    supports_long_context=True,
    source="hf:google/gemma-3-1b-pt; unverified",
    notes="5:1 local:global; tied embeddings; kv=1 (MQA)",
)
