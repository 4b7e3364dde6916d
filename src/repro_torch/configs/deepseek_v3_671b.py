"""deepseek-v3-671b — MoE with Multi-head Latent Attention.

[arXiv:2412.19437; hf] 61L d_model=7168 128H d_ff=2048(expert) vocab=129280,
MoE 256 routed top-8 + 1 shared expert; first 3 layers dense (d_ff 18432);
MLA: q_lora 1536, kv_lora 512, rope_head 64, nope_head 128, v_head 128.
MTP (multi-token prediction) is a training objective variant — we train the
main next-token head (MTP depth-0), noted in DESIGN.md.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,        # MLA: kv heads == heads, latent-compressed cache
    d_ff=2048,             # per-expert hidden (assignment value)
    vocab=129280,
    attn_impl="mla",
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_rope_head_dim=64,
    qk_nope_head_dim=128,
    v_head_dim=128,
    head_dim=192,          # nope + rope
    n_experts=256,
    top_k=8,
    n_shared_experts=1,
    moe_d_ff=2048,
    first_k_dense=3,
    dense_d_ff=18432,
    capacity_factor=1.25,
    rope_theta=1e4,
    supports_long_context=False,
    source="arXiv:2412.19437; hf",
    notes="MLA latent KV cache; 1 shared + 256 routed top-8",
)
