"""tracelint configuration for the port: scopes, boundaries, key schemas.

The port's own inventory, derived from the port's code (the JAX
package's `repro.analysis.config` lists that package's).  Everything
rule-specific but repo-specific lives here, so the rules stay mechanical
and this file reads as the *inventory of sanctioned exceptions* to the
device-loop invariants:

* `HOST_BOUNDARIES` — the functions allowed to read the device from the
  host (``.item()`` / ``.cpu()`` / ``.tolist()`` / ``np.asarray`` /
  ``int()`` of a tensor).  Every entry says why it is a boundary: graph
  construction, stream validation, the one read per `SYNC_EVERY`
  supersteps of a fixpoint, the one copy per window / batch.
* `CACHE_SCHEMAS` — every cache of the port and the names its key must
  contain.  A cache site (an `lru_cache`, or a `*cache*` dict) that is
  not registered here is itself a finding.
* `SEED_PREFIXES` — the port's seed substrate: the LM models, the
  optimizer, the token pipelines, the sharding rules and the fault
  harness, and the training launcher (as in the JAX
  package, whose `configs` also hold the service's knobs and stay scanned
  here).

Paths are POSIX-relative to the scan root (the directory containing the
`repro_torch` package), e.g. ``repro_torch/runtime/spmd.py``.
"""
from __future__ import annotations

from typing import Dict, FrozenSet, Tuple

#: the port's package, the prefix of every path the rules scope on
PACKAGE = "repro_torch"

#: packages whose device loops the host-sync / retrace rules protect
SYNC_SCOPE: Tuple[str, ...] = (
    "repro_torch/core/",
    "repro_torch/kernels/",
    "repro_torch/runtime/",
    "repro_torch/service/",
)

#: quarantined seed substrate — excluded from every AST rule; the
#: dead-seed audit checks these carry a `seed_fixtures` note instead
SEED_PREFIXES: Tuple[str, ...] = (
    "repro_torch/models/",
    "repro_torch/optim/",
    "repro_torch/data/",
    "repro_torch/distributed/",
    "repro_torch/launch/",
)

#: reachability roots for the dead-seed import audit: everything in these
#: packages is product surface; a port module outside them must be
#: imported (transitively) by them
REACHABILITY_ROOTS: Tuple[str, ...] = (
    "repro_torch.core",
    "repro_torch.kernels",
    "repro_torch.runtime",
    "repro_torch.service",
    "repro_torch.graphgen",
)

#: the literal token a quarantined package's `__init__` docstring must
#: contain for the dead-seed audit to accept it (the port's own root
#: `__init__` carries it for the JAX package's audit, and is not read as
#: a marker here: see `imports`)
SEED_MARKER = "seed_fixtures"

#: packages no module of the port may import (`imports.audit_port_imports`)
FORBIDDEN_IMPORTS: Tuple[str, ...] = ("jax", "jaxlib", "repro")

#: the pow2 bucket helpers — the ONLY sanctioned way a shape-derived host
#: scalar may reach a cache key.  Functions named here are exempt from
#: the shape-derived check on their own bodies (they ARE the helpers).
BUCKET_HELPERS: FrozenSet[str] = frozenset({
    "_pow2_bucket",
    "degree_bound",
    "batch_bucket",
    "topk_bucket",
})

#: host-boundary whitelist for the host-sync rule.
#:
#: Maps file -> set of function names (innermost OR any enclosing def)
#: allowed to read the device, or "*" for a whole host-numpy module.
#: Every entry says WHY it is a boundary; anything not listed that reads
#: the device in SYNC_SCOPE is a finding.
HOST_BOUNDARIES: Dict[str, FrozenSet[str]] = {
    # graph construction and host-side accessors (numpy in, numpy out);
    # the device mutation path (insert_edge/delete_edge, _sorted_*_row)
    # is deliberately NOT listed
    "repro_torch/core/graph.py": frozenset({
        "build_blocks", "from_numpy", "to_numpy", "n_real", "m_real",
        "edge_cut", "halo_slot_counts", "halo_pair_counts",
        "to_networkx_edges",
        # migration and capacity escalation: host numpy on the concrete
        # adjacency; `_remap_ids` uploads their host id map
        "migrate_vertices", "grow_blocks", "relocate_rows",
        "add_vertices_host", "_remap_ids",
    }),
    # host splice/validation module: the numpy twin of the update path
    # (`validate_updates` copies nbr/deg once per window)
    "repro_torch/core/updates.py": frozenset({"*"}),
    # hub splitting / mirror-plan maintenance: planning, replica
    # allocation and per-edit slice splices on the host; the superstep
    # merge lives in kernels/ops.py, protected
    "repro_torch/core/hub_split.py": frozenset({"*"}),
    # host-side partitioners (numpy throughout)
    "repro_torch/core/partition.py": frozenset({"*"}),
    "repro_torch/core/partition_dynamic.py": frozenset({"*"}),
    # host Bron-Kerbosch / degree summaries (numpy throughout)
    "repro_torch/core/cliques.py": frozenset({"*"}),
    "repro_torch/core/degree.py": frozenset({"*"}),
    # coreness host wrapper: a documented host-int return
    "repro_torch/core/kcore.py": frozenset({"max_coreness"}),
    # maintenance: the one read of the frontier counter per SYNC_EVERY
    # hops (k_reachable_batch), the bundled stats read per batch (_stats)
    # and the per-batch candidate pull of the host loop (maintain_batch)
    "repro_torch/core/kcore_dynamic.py": frozenset({
        "k_reachable_batch", "_stats", "maintain_batch",
    }),
    # the sanctioned reads of the kernel layer: the one read per
    # SYNC_EVERY supersteps of a fixpoint (live_loop, minh_fixpoint), the
    # column bound once per fixpoint (column_bound; coreness_dense's K),
    # and a mirror plan's host merge index, once per run (merge_index)
    "repro_torch/kernels/ops.py": frozenset({
        "live_loop", "minh_fixpoint", "column_bound", "coreness_dense",
        "merge_index",
    }),
    # reference oracles are host-side by design
    "repro_torch/kernels/ref.py": frozenset({"*"}),
    # host build and ctypes loading: launches pass addresses and read no
    # tensor value
    "repro_torch/kernels/_build.py": frozenset({"*"}),
    # halo plans are BUILT on the host from the concrete adjacency (at
    # open / apply_updates time, never per superstep); the worker mesh is
    # host setup
    "repro_torch/runtime/halo.py": frozenset({"*"}),
    "repro_torch/runtime/mesh.py": frozenset({"*"}),
    # crash recovery: evacuation planning, window-log replay and the
    # kill/restore drill are host protocol work
    "repro_torch/runtime/recovery.py": frozenset({"*"}),
    # the stream's host side: the ONE verdict copy per window and host
    # counters over it (apply_window); host id arithmetic (_compose_perm);
    # host relocation on a grow; the checkpoint boundary (from_state)
    "repro_torch/runtime/stream.py": frozenset({
        "apply_window", "_compose_perm", "grow", "from_state",
    }),
    # THE one copy per answered batch (_to_host) and the host lists
    # built from it (run_batch)
    "repro_torch/service/queries.py": frozenset({"_to_host", "run_batch"}),
    # snapshot cut: the host primary-row map of a mirrored session
    "repro_torch/service/state.py": frozenset({"refresh"}),
}

#: every cache of the port and the names its key carries.  lru_cache
#: sites key on their parameter list; dict caches key on the tuple
#: expression stored/looked up.  Eager PyTorch compiles nothing, so the
#: JAX package's compiled-step caches have no counterpart; the port's
#: caches are the CUDA libraries it builds and loads.
CACHE_SCHEMAS: Dict[str, Tuple[str, ...]] = {
    # one build of every source per process (the library names hash the
    # sources, the headers and the flags; `_build._library_path`)
    "repro_torch/kernels/_build.py::build_all": (),
    # one loaded launch function per kernel
    "repro_torch/kernels/_build.py::launcher": ("name",),
}

#: approved sorted-ELL splice/sort helpers: a `nbr` write whose value
#: routes through one of these calls preserves the invariant
SORTED_ELL_HELPERS: FrozenSet[str] = frozenset({
    "sort_nbr_rows",       # core/graph.py: host rows, ascending, PAD last
    "_sorted_rows",        # core/graph.py: the same on a device tensor
    "_sorted_insert_row",  # core/graph.py: one row, one id in
    "_sorted_delete_row",  # core/graph.py: one row, one id out
    "_insert_sorted",      # core/updates.py: host splice, in place
    "_delete_sorted",      # core/updates.py
    # hub-split slice splices (host numpy, in place on one (Cd,) slice)
    "_sorted_slice_insert",
    "_sorted_slice_delete",
})

#: functions allowed to write `nbr` raw: the helpers themselves plus the
#: constructors that establish the invariant with a terminal sort, and
#: the host appliers that splice through the approved helpers
SORTED_ELL_WRITERS: FrozenSet[str] = SORTED_ELL_HELPERS | frozenset({
    "build_blocks",        # core/graph.py: ends with sort_nbr_rows
    "build_ell_random",    # core/graph.py: ends with sort_nbr_rows
    "apply_updates_host",  # core/updates.py: splices row by row
    "_apply_checked",      # core/updates.py: the same, checked
    # split_hubs rewires into fresh replica rows and re-sorts;
    # apply_mirrored_edits splices through the slice helpers;
    # run_common_mirror's canonical view is re-sorted
    "split_hubs",
    "apply_mirrored_edits",
    "run_common_mirror",
    # hub_split's constructor of a graph from those callers' arrays
    "_graph",
    # grow_blocks / migrate_vertices remap ids through a MONOTONE rekey or
    # re-sort the moved rows (`_remap_ids`, `_sorted_rows`)
    "grow_blocks",
    "migrate_vertices",
    # snapshot restore re-adopts arrays saved from an invariant-holding
    # graph verbatim (checkpoints are bit-exact copies)
    "from_state",
})


def in_sync_scope(path: str) -> bool:
    """True if `path` (root-relative POSIX) is protected by the
    host-sync / retrace rules."""
    return path.startswith(SYNC_SCOPE) and not is_seed(path)


def is_seed(path: str) -> bool:
    """True if `path` lies in a quarantined seed-substrate package."""
    return bool(SEED_PREFIXES) and path.startswith(SEED_PREFIXES)


def boundary_functions(path: str) -> FrozenSet[str]:
    """Whitelisted host-boundary function names for `path`."""
    return HOST_BOUNDARIES.get(path, frozenset())
