"""Architecture & shape configuration system.

One `ArchConfig` describes any of the 10 assigned architectures (plus the
paper's own graph workloads, which live in `bladyg_graph.py`).  `reduced()`
returns a structurally-identical tiny config for CPU smoke tests; the full
config is what `models.build` serves on the card.  Fields, defaults and
`reduced()` are the JAX package's, field for field.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    vocab: int
    d_ff: int = 0
    head_dim: int = 0              # 0 -> d_model // n_heads

    # --- layer pattern -----------------------------------------------------
    mixer: str = "attn"            # attn | mamba
    sliding_window: int = 0        # >0: window size for local layers
    local_global_period: int = 0   # gemma3: every p-th layer is global
    shared_attn_period: int = 0    # zamba2: shared attn block every p mamba layers

    # --- attention flavor ----------------------------------------------------
    attn_impl: str = "gqa"         # gqa | mla
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_rope_head_dim: int = 0
    qk_nope_head_dim: int = 0
    v_head_dim: int = 0

    # --- MoE -----------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0
    first_k_dense: int = 0         # deepseek: leading dense layers
    dense_d_ff: int = 0            # d_ff of those dense layers
    capacity_factor: float = 1.25

    # --- SSM (mamba2) ----------------------------------------------------------
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    conv_width: int = 4
    ssm_groups: int = 1

    # --- enc-dec / multimodal ---------------------------------------------------
    enc_layers: int = 0            # >0: encoder-decoder (seamless)
    n_prefix_tokens: int = 0       # vlm: pre-embedded patch tokens
    prefix_dim: int = 0            # raw dim of stub embeddings
    mem_len: int = 4096            # enc-dec decode: encoder memory length

    # --- misc ---------------------------------------------------------------
    rope_theta: float = 1e4
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    supports_long_context: bool = False  # run long_500k?
    source: str = ""
    notes: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def is_encdec(self) -> bool:
        return self.enc_layers > 0

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def reduced(self) -> "ArchConfig":
        """Structurally-identical tiny config for CPU smoke tests."""
        period = max(self.local_global_period, self.shared_attn_period)
        layers = max(2, 2 * period) if period else (4 if self.first_k_dense else 2)
        hd = 16
        heads = max(2, min(4, self.n_heads))
        kv = max(1, min(self.n_kv_heads, heads))
        return dataclasses.replace(
            self,
            n_layers=layers,
            d_model=64,
            n_heads=heads,
            n_kv_heads=kv,
            head_dim=hd,
            d_ff=96 if self.d_ff else 0,
            vocab=512,
            q_lora_rank=24 if self.q_lora_rank else 0,
            kv_lora_rank=16 if self.kv_lora_rank else 0,
            qk_rope_head_dim=8 if self.qk_rope_head_dim else 0,
            qk_nope_head_dim=8 if self.qk_nope_head_dim else 0,
            v_head_dim=hd if self.v_head_dim else 0,
            n_experts=4 if self.n_experts else 0,
            top_k=min(2, self.top_k) if self.top_k else 0,
            moe_d_ff=64 if self.moe_d_ff else 0,
            first_k_dense=min(1, self.first_k_dense),
            dense_d_ff=96 if self.dense_d_ff else 0,
            ssm_state=16 if self.ssm_state else 0,
            ssm_head_dim=16 if self.ssm_state else 64,
            sliding_window=32 if self.sliding_window else 0,
            enc_layers=2 if self.enc_layers else 0,
            n_prefix_tokens=8 if self.n_prefix_tokens else 0,
            prefix_dim=48 if self.prefix_dim else 0,
            mem_len=16 if self.is_encdec else 4096,
            dtype="float32",
            notes="REDUCED smoke config",
        )


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str        # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", "train", 4_096, 256),
    ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    ShapeConfig("decode_32k", "decode", 32_768, 128),
    ShapeConfig("long_500k", "decode", 524_288, 1),
)

SHAPES_BY_NAME = {s.name: s for s in SHAPES}


def cell_applicable(cfg: ArchConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Is (arch, shape) runnable?  Returns (ok, reason-if-skip).

    Per assignment: ``long_500k`` only for sub-quadratic-state archs;
    all 10 archs have decoders, so decode shapes apply everywhere.
    """
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, (
            "pure full-attention arch: 524k-token decode excluded per "
            "assignment (no sub-quadratic state); see DESIGN.md §Arch-applicability"
        )
    return True, ""
