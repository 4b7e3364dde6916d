"""The LM substrate on PyTorch (the JAX package's `models`): serving and
the training loss with its gradient (`value_and_grad`, activation
checkpointing under `remat`).

Dict-of-tensors parameters with each block's layers stacked on a leading
axis, as the reference's pytrees; `build(cfg)` serves and trains all ten
architectures: every decoder-only one (`dense_uniform`, `gemma_period`,
the prefix-LM stub, `moe_uniform` with GQA or MLA attention,
`mamba_uniform`, `zamba_period`) and the encoder-decoder (`encdec`).

seed_fixtures: quarantined seed substrate, as in the JAX package — held
against it by `tests/test_torch_models.py`, `tests/test_torch_encdec.py`
and `tests/test_torch_train.py` and run on the card by `chip_smoke.py`'s
`serve_lm` and `train_lm` phases, never imported by the port's product
packages (`repro_torch.{core,kernels,runtime,service}`).
"""
from .model_zoo import (
    build, ModelBundle, cross_entropy, param_count, params_from_numpy,
    params_to_numpy, value_and_grad,
)
from . import attention, encdec, layers, moe, ssm, transformer

__all__ = [
    "build", "ModelBundle", "cross_entropy", "param_count",
    "params_from_numpy", "params_to_numpy", "value_and_grad", "attention",
    "encdec", "layers", "moe", "ssm", "transformer",
]
