"""seamless-m4t-large-v2 — enc-dec multimodal (speech) transformer.

[arXiv:2308.11596; hf] 24L d_model=1024 16H (GQA kv=16) d_ff=8192
vocab=256206.  The speech frontend is a STUB per assignment: input_specs()
provides precomputed frame embeddings (B, S, d_model) for the encoder.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    n_layers=24,          # decoder depth
    enc_layers=24,        # encoder depth
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab=256206,
    mem_len=4096,         # encoder memory length for decode cells
    rope_theta=1e4,
    supports_long_context=False,  # full attention; 524k decode skipped
    source="arXiv:2308.11596; hf",
    notes="enc-dec; audio frontend stubbed to precomputed frame embeddings",
)
