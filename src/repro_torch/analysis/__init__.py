"""tracelint for the port: static analysis of the device-loop invariants.

The port's counterpart of the JAX package's `repro.analysis`, with its
own copy of everything it needs (it imports nothing of `repro`):

* :mod:`repro_torch.analysis.engine` — AST scan, ``# tracelint:``
  pragmas, the committed-baseline mechanism (the JAX package's engine,
  same results on the same inputs).
* :mod:`repro_torch.analysis.rules` — the five AST rules (``host-sync``,
  ``retrace-hazard``, ``sorted-ell``, ``cache-key``, ``cuda-kernel``).
* :mod:`repro_torch.analysis.config` — the port's boundary whitelists,
  cache-key schemas, bucket-helper and package inventories.
* :mod:`repro_torch.analysis.imports` — the ``dead-seed`` import-graph
  audit and the ``port-import`` rule (no module of the port imports
  `jax` or `repro`).
* :mod:`repro_torch.analysis.entrypoints` — the ``entrypoint-audit``
  host-read budgets and sync probes, as a manifest (`count_host_reads`,
  `probe_syncs`; on a card also `count_cuda_syncs`).

The JAX package's `count_device_gets` and `forbidden_primitives` are not
carried: eager PyTorch has no transfer function every read goes through
and no program to scan before it runs; `count_host_reads` and
`probe_syncs` take their places.

CLI: ``PYTHONPATH=src python -m repro_torch.analysis --check`` (on the
CPU with ``--device cpu``; see ``__main__``).
"""
from .engine import (  # noqa: F401
    Finding,
    ModuleSource,
    Rule,
    RULES,
    load_baseline,
    partition_findings,
    scan_source,
    scan_tree,
    write_baseline,
)
from .entrypoints import (  # noqa: F401
    MANIFEST,
    count_host_reads,
    probe_syncs,
    run_audit,
)
from .imports import (  # noqa: F401
    audit_dead_seed,
    audit_port_imports,
    build_import_graph,
)

__all__ = [
    "Finding", "ModuleSource", "Rule", "RULES",
    "scan_source", "scan_tree",
    "load_baseline", "write_baseline", "partition_findings",
    "MANIFEST", "run_audit", "count_host_reads", "probe_syncs",
    "audit_dead_seed", "audit_port_imports", "build_import_graph",
]
