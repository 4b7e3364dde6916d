"""PyTorch port vs the JAX package: static coreness (the min-H fixpoint).

`repro_torch.core.coreness_with_stats` against
`repro.core.coreness_with_stats(backend="ell")` (Pallas in interpret
mode): the coreness vector AND the superstep count must be EQUAL — they
are integers.  Covers BA, ER and ragged graphs (padding rows, Cd not a
power of two, isolated nodes), and ``max_steps=3``, which stops inside the
first chunk of the port's every-8-supersteps convergence check.
"""
import numpy as np
import pytest
import torch

from _hyp import given, settings, st
from _torch_port import (  # noqa: F401 (fixtures)
    needs_cuda, one_torch_thread, require_cuda, to_port)

import repro.core as jcore
import repro.core.partition as jpart
import repro.graphgen as jgen

import repro_torch.core as tcore
from repro_torch.kernels import ops

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _ref_graph(kind, seed, P=4):
    if kind == "ba":
        edges = jgen.barabasi_albert(150, 4, seed=seed)
    elif kind == "er":
        edges = jgen.erdos_renyi(120, 360, seed=seed)
    else:  # ragged: NN growth, isolated tail nodes, padding rows, odd Cd
        edges = jgen.nearest_neighbor_graph(90, u=0.8, seed=seed)
    n = int(edges.max()) + 1 + (5 if kind == "ragged" else 0)
    assign = jpart.node_random_partition(n, P, seed=seed)
    return jcore.build_blocks(edges, n, assign, P=P, deg_slack=7,
                              node_slack=3 if kind == "ragged" else 0)


@pytest.mark.parametrize("kind", ["ba", "er", "ragged"])
@pytest.mark.parametrize("backend", ["torch", "ell"])
def test_coreness_equals_reference(kind, backend):
    jg = _ref_graph(kind, seed=3)
    want, want_steps = jcore.coreness_with_stats(jg, backend="ell")
    got, steps = tcore.coreness_with_stats(to_port(jg), backend=backend)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert steps == want_steps


@pytest.mark.parametrize("max_steps", [0, 1, 3, 8, 9])
def test_max_steps_cut_equals_reference(max_steps):
    """A cut fixpoint returns the reference's partial estimates and count."""
    jg = _ref_graph("ba", seed=5)
    want, want_steps = jcore.coreness_with_stats(jg, max_steps=max_steps,
                                                 backend="ell")
    got, steps = tcore.coreness_with_stats(to_port(jg), max_steps=max_steps,
                                           backend="ell")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert steps == want_steps == min(max_steps, steps)


def _cascade_graph():
    """A long path with a dense head: coreness settles over many
    supersteps, well past one 8-superstep chunk."""
    path = np.stack([np.arange(40), np.arange(1, 41)], 1)
    head = np.array([(i, j) for i in range(6) for j in range(i + 1, 6)])
    edges = np.concatenate([path, head + 41])
    return edges, 47


def test_many_chunks_equal_reference():
    edges, n = _cascade_graph()
    assign = jpart.node_hash_partition(n, 3)
    jg = jcore.build_blocks(edges, n, assign, P=3)
    want, want_steps = jcore.coreness_with_stats(jg, backend="ell")
    got, steps = tcore.coreness_with_stats(to_port(jg), backend="ell")
    assert want_steps > 2 * ops.SYNC_EVERY
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert steps == want_steps


@settings(max_examples=5, deadline=None)
@given(st.integers(12, 80), st.integers(0, 10_000), st.integers(1, 4))
def test_coreness_property(n, seed, P):
    edges = jgen.barabasi_albert(n, 3, seed=seed)
    nn = int(edges.max()) + 1
    jg = jcore.build_blocks(edges, nn,
                            jpart.node_random_partition(nn, P, seed=seed),
                            P=P, deg_slack=5)
    want, want_steps = jcore.coreness_with_stats(jg, backend="jnp")
    got, steps = tcore.coreness_with_stats(to_port(jg), backend="torch")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert steps == want_steps


def test_coreness_auto_step_and_max():
    jg = _ref_graph("er", seed=2)
    tg = to_port(jg)
    core = tcore.coreness(tg)  # auto -> torch on a CPU graph
    np.testing.assert_array_equal(core.numpy(),
                                  np.asarray(jcore.coreness(jg, backend="jnp")))
    assert tcore.max_coreness(tg) == int(np.asarray(core).max())
    est0 = torch.where(tg.node_mask, tg.deg, 0)
    new, changed = tcore.coreness_step(tg, est0, tg.node_mask)
    assert bool(changed) == bool((new != est0).any())
    assert ops.degree_bound(tg) == min(tg.Cd, ops._pow2_bucket(
        int(tg.deg.max())))


@needs_cuda
@pytest.mark.parametrize("kind", ["ba", "ragged"])
def test_coreness_kernel_path_on_gpu(kind):
    jg = _ref_graph(kind, seed=1)
    want, want_steps = jcore.coreness_with_stats(jg, backend="jnp")
    got, steps = tcore.coreness_with_stats(to_port(jg, device="cuda"),
                                           backend="ell")
    np.testing.assert_array_equal(got.cpu().numpy(), np.asarray(want))
    assert steps == want_steps


def test_hindex_rows_is_re_exported():
    """Queue 3 fault 4: `hindex_rows` from `core.kcore` and `core`, as the
    reference re-exports it, with the reference's values."""
    import repro_torch.core.kcore as tkcore
    from repro_torch.kernels.ell_hindex import hindex_rows

    assert tkcore.hindex_rows is tcore.hindex_rows is hindex_rows
    rng = np.random.default_rng(3)
    vals = rng.integers(-1, 9, (40, 7)).astype(np.int32)
    np.testing.assert_array_equal(
        tcore.hindex_rows(torch.from_numpy(vals)).numpy(),
        np.asarray(jcore.hindex_rows(vals)))


#: public names of the reference that the port leaves out on purpose:
#: the reference's auto-crossover tables (measured on a TPU only), the
#: Pallas row-chunk tile, the trace and compile counters (eager PyTorch
#: traces and compiles nothing), the jax mesh's shardings (the process
#: group stands in for them), the layer scans' full unroll (`unrolling`
#: serves only XLA's dry-run cost count; the port's loop is unrolled
#: already), and tracelint's jax-only pieces: the `jax.device_get` counter
#: and the jaxpr scan (eager PyTorch has no transfer function every read
#: goes through and no program to scan before it runs: `count_host_reads`
#: and `probe_syncs` take their places), the Pallas rule (`cuda-kernel`
#: takes its place), the jit-factory inventory (nothing is jitted), and
#: the launcher's XLA flags for a TPU's latency-hiding scheduler and
#: async collectives (XLA options; eager PyTorch has no scheduler to set)
LEFT_OUT = {
    "analysis": {"count_device_gets"},
    "analysis.entrypoints": {"count_device_gets", "forbidden_primitives",
                             "FORBIDDEN_FRAGMENTS"},
    "analysis.rules": {"PallasKernelRule"},
    "analysis.config": {"JIT_FACTORIES"},
    "kernels.ops": {"AUTO_CROSSOVER", "JNP_AUTO_MAX", "DENSE_AUTO_MAX",
                    "MIN_FILL", "gather_trace_count"},
    "kernels.ell_cc": {"CHUNK"},
    "kernels.ell_frontier": {"CHUNK"},
    "service": {"query_trace_count"},
    "service.queries": {"query_trace_count"},
    "runtime.spmd": {"step_build_count"},
    "runtime.mesh.WorkerMesh": {"node_sharding", "replicated"},
    "models.scan_util": {"unrolling"},
    "launch.train": {"TPU_OVERLAP_FLAGS"},
}
#: modules of the reference the port leaves out on purpose
MODULES_LEFT_OUT = {
    "kernels._compat": "jax version shims for Pallas (`CompilerParams`); "
    "the port's kernels are CUDA C++ built by `kernels._build`",
}
#: modules of the reference that set XLA_FLAGS and REPRO_SCAN_UNROLL=1
#: when imported (the reference's scans read the latter at every call):
#: their public names are read in a subprocess, never in this process
IMPORT_IN_SUBPROCESS = {"launch.dryrun", "launch.extrapolate"}
#: where a public name is an import of a library, not the module's own
_LIBRARIES = ("typing", "numpy", "jax", "jaxlib", "torch", "dataclasses",
              "functools", "collections", "__future__", "abc", "enum",
              "pathlib", "threading", "heapq", "itertools", "warnings",
              "math", "json", "time", "os", "contextlib")


def _public(obj):
    import types

    out = set()
    for n in dir(obj):
        if n.startswith("_"):
            continue
        v = getattr(obj, n)
        if isinstance(v, types.ModuleType):
            continue
        mod = getattr(v, "__module__", None)
        if isinstance(mod, str) and mod.split(".")[0] in _LIBRARIES:
            continue
        if type(v).__module__.split(".")[0] in ("typing", "__future__"):
            continue
        out.add(n)
    return out


def _public_in_subprocess(module: str) -> set:
    """`_public` of `module`, imported in a subprocess (no class of those
    modules is the reference's own, so their members need no check)."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    tests = Path(__file__).resolve().parent
    code = (f"import importlib, json, sys; sys.path.insert(0, {str(tests)!r})"
            "; from test_torch_kcore import _public; print(json.dumps("
            f"sorted(_public(importlib.import_module({module!r})))))")
    env = dict(os.environ, PYTHONPATH=str(tests.parent / "src"),
               JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    return set(json.loads(r.stdout.strip().splitlines()[-1]))


def _module_names(path, prefix=""):
    """The modules under a package directory, by the files alone: nothing
    is imported."""
    import pkgutil

    out = set()
    for info in pkgutil.iter_modules([str(path)]):
        name = prefix + info.name
        out.add(name)
        if info.ispkg:
            out |= _module_names(path / info.name, name + ".")
    return out


def test_modules_equal_reference():
    """Every module of the reference has a module of the port, apart from
    `MODULES_LEFT_OUT`; and nothing is listed there that the port has."""
    from pathlib import Path

    import repro
    import repro_torch

    ref = _module_names(Path(repro.__path__[0]))
    port = _module_names(Path(repro_torch.__path__[0]))
    assert ref - port == set(MODULES_LEFT_OUT)
    assert all(MODULES_LEFT_OUT.values())


def test_public_names_equal_reference():
    """Queue 3 fault 4: every public name (and every public class member)
    of each module of the reference that the port ports exists in the
    port, apart from `LEFT_OUT`; and nothing is listed there that the
    port has."""
    import importlib
    import pkgutil
    import warnings

    import repro_torch

    missing = {}
    for info in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
        rel = info.name[len("repro_torch."):]
        assert rel not in MODULES_LEFT_OUT
        port = importlib.import_module(info.name)
        if rel in IMPORT_IN_SUBPROCESS:
            miss = _public_in_subprocess("repro." + rel) - _public(port)
            if miss:
                missing[rel] = miss
            continue
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", DeprecationWarning)
                ref = importlib.import_module("repro." + rel)
        except ImportError:
            continue  # the port's own modules (device, kernels._build)
        want, have = _public(ref), _public(port)
        miss = want - have
        for n in want & have:
            rv, pv = getattr(ref, n), getattr(port, n)
            if isinstance(rv, type) and isinstance(pv, type) \
                    and rv.__module__ == ref.__name__:
                m = {a for a in dir(rv) if not a.startswith("_")} - \
                    {a for a in dir(pv) if not a.startswith("_")}
                if m:
                    missing[f"{rel}.{n}"] = m
        if miss:
            missing[rel] = miss
    assert missing == LEFT_OUT
