"""Distributed substrate on PyTorch (the JAX package's `distributed`):
the fault harness (`fault`).  The sharding rules (`sharding`) are not
ported yet (ROADMAP.md Queue 1).

seed_fixtures: ``fault`` is quarantined seed substrate, as in the JAX
package — the fault-injection harness for the LLM training loop, held
against the reference by `tests/test_torch_train_parts.py`, never
imported by the port's product packages.

Marker-only package ``__init__``: importing it must stay side-effect
free (no submodule imports).
"""
