"""Optimizer substrate on PyTorch (the JAX package's `optim`): AdamW
(+ schedule, clipping), gradient compression.

seed_fixtures: quarantined seed substrate, as in the JAX package — held
against it by `tests/test_torch_optim.py` and run on the card by
`chip_smoke.py`'s `train_parts` phase, never imported by the port's
product packages (`repro_torch.{core,kernels,runtime,service}`).
"""
from .adamw import AdamWConfig, AdamWState, init, update, cosine_lr, global_norm
from .compress import (
    quantize_int8, dequantize_int8, init_error_feedback, compressed_psum_mean,
)

__all__ = [
    "AdamWConfig", "AdamWState", "init", "update", "cosine_lr", "global_norm",
    "quantize_int8", "dequantize_int8", "init_error_feedback",
    "compressed_psum_mean",
]
