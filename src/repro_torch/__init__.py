"""BLADYG on PyTorch and CUDA: dynamic k-core maintenance on one NVIDIA GPU.

A port of the JAX package `repro` (which stays the reference) to PyTorch,
with the two kernels of the main path written by hand in CUDA C++ for
Hopper (`kernels/csrc/`).  The main path is the paper's first
application: build the block-partitioned ELL graph (`core.graph`),
compute static coreness with the min-H fixpoint (`core.kcore`), keep it
exact under edge inserts and deletes with Theorem-1 maintenance
(`core.kcore_dynamic`), and drive that from an update stream
(`runtime.stream`).

This package carries a seed_fixtures note for the JAX package's dead-seed
import audit: it is not seed substrate but a separate port, which the
audit of `repro` cannot reach because no module of `repro` imports it.

Entry points that create tensors take `device=` and run on CUDA unless
the caller passes ``device="cpu"`` (`device.resolve_device`); functions
that take a graph run on the graph's device.
"""
