"""Distributed substrate on PyTorch (the JAX package's `distributed`):
the sharding rules (`sharding`: parameter, optimizer, batch and cache
layouts on a mesh description) and the fault harness (`fault`).

seed_fixtures: quarantined seed substrate, as in the JAX package — the
rules and the fault-injection harness of the LLM training loop, held
against the reference by `tests/test_torch_sharding.py` and
`tests/test_torch_train_parts.py`, read by the training launcher
(`launch.train`), never imported by the port's product packages.

Marker-only package ``__init__``: importing it must stay side-effect
free (no submodule imports).
"""
