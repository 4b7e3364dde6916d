"""The LM substrate's serve path on PyTorch (the JAX package's `models`).

Dict-of-tensors parameters with each block's layers stacked on a leading
axis, as the reference's pytrees; `build(cfg)` serves every decoder-only
architecture (`dense_uniform`, `gemma_period`, the prefix-LM stub,
`moe_uniform` with GQA or MLA attention, `mamba_uniform`, `zamba_period`)
and refuses the encoder-decoder until its step of ROADMAP.md Queue 1
item 9.  The JAX package's `encdec` module is not ported yet.

seed_fixtures: quarantined seed substrate, as in the JAX package — held
against it by `tests/test_torch_models.py` and run on the card by
`chip_smoke.py`'s `serve_lm` phase, never imported by the port's product
packages (`repro_torch.{core,kernels,runtime,service}`).
"""
from .model_zoo import (
    build, ModelBundle, cross_entropy, param_count, params_from_numpy,
    params_to_numpy,
)
from . import attention, layers, moe, ssm, transformer

__all__ = [
    "build", "ModelBundle", "cross_entropy", "param_count",
    "params_from_numpy", "params_to_numpy", "attention", "layers", "moe",
    "ssm", "transformer",
]
