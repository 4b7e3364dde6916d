"""llama4-scout-17b-a16e — MoE (16 experts, top-1) + shared expert.

[hf:meta-llama/Llama-4-Scout-17B-16E; unverified] 48L d_model=5120 40H
(GQA kv=8) d_ff=8192 vocab=202048, MoE 16e top-1, early fusion.
Text backbone only (early-fusion frontend out of assignment scope);
every layer MoE with one shared expert, per the HF config.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab=202048,
    n_experts=16,
    top_k=1,
    n_shared_experts=1,
    moe_d_ff=8192,
    capacity_factor=1.25,
    rope_theta=5e5,
    supports_long_context=False,
    source="hf:meta-llama/Llama-4-Scout-17B-16E; unverified",
    notes="MoE top-1 + shared expert every layer; text backbone",
)
