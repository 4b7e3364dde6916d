"""BLADYG on PyTorch and CUDA: dynamic graph analytics on one NVIDIA GPU.

A port of the JAX package `repro` (which stays the reference) to PyTorch,
with the kernels of its paths written by hand in CUDA C++ for Hopper
(`kernels/csrc/`).  The main path is the paper's first application:
build the block-partitioned ELL graph (`core.graph`), compute static
coreness with the min-H fixpoint (`core.kcore`), keep it exact under edge
inserts and deletes with Theorem-1 maintenance (`core.kcore_dynamic`),
and drive that from an update stream (`runtime.stream`).  The framework
path runs any `BlockProgram` (`core.engine`) — connected components,
PageRank, triangle counting, their fused form (`core.algorithms`) —
through one runner (`kernels.ops.run_block_program`), and keeps CC labels
exact in the stream.  The elastic stream (`runtime.stream.StreamSession`)
rebalances its blocks live by the paper's §4.2 protocol
(`core.partition_dynamic`, `core.graph.migrate_vertices`), grows its
capacities (`core.graph.grow_blocks`) and saves and resumes itself
(`checkpoint`); the query service (`service`) answers typed queries
between its windows.  Hub mirroring (`core.hub_split`) splits skewed
graphs' hubs into replica rows, so every workload and the stream
(`runtime.stream.MirrorStream`) run with `Cd` bounded by a threshold.
The mesh runtime (`runtime.mesh`, `runtime.halo`, `runtime.spmd`) runs
the primitives, the programs, maintenance, the stream, restore and the
service on a `torch.distributed` worker mesh, one process per worker
(``backend="ell_spmd"``), and `runtime.recovery` brings a stream back
exact after a worker loss.

Beside the graph system, the JAX package's seed LM substrate: its
architecture configs are ported (`configs`: `ARCHS`, `get_arch`,
`SHAPES`, `GRAPH_TASKS`), and `models` serves the dense decoder family
(internlm2, codeqwen, granite, gemma3, the paligemma prefix-LM) through
`build(cfg)`: `init`, `cache_init`, `prefill_fn`, `decode_fn`.  No module
of the graph system imports `models`.

This package carries a seed_fixtures note for the JAX package's dead-seed
import audit: it is not seed substrate but a separate port, which the
audit of `repro` cannot reach because no module of `repro` imports it.

Entry points that create tensors take `device=` and run on CUDA unless
the caller passes ``device="cpu"`` (`device.resolve_device`); functions
that take a graph run on the graph's device.
"""
