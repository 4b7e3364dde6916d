"""Data pipelines (the JAX package's `data`): numpy token batches.

seed_fixtures: quarantined seed substrate, as in the JAX package — token
pipelines for the model plumbing, held against it by
`tests/test_torch_train_parts.py`, never imported by the port's product
packages (`repro_torch.{core,kernels,runtime,service}`).
"""
from .pipeline import SyntheticTokens, ByteCorpus
__all__ = ["SyntheticTokens", "ByteCorpus"]
