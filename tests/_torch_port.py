"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

* `reference()` imports the JAX package's stream runtime (and
  `reference_service()` its query service, which imports it).  Importing
  `repro.runtime` raises a DeprecationWarning from `repro/runtime/spmd.py`
  (jax's shard_map move), which the suite's filterwarnings turn into an
  error; the import here runs with that warning ignored, so the port's
  tests can use the reference without touching it.  It runs once when
  this module loads (at collection, in every test worker), not at the
  first test that asks for it: otherwise whether a test that imports
  `repro.runtime` itself (ARCHITECTURE.md's doctests, test files
  collected after this one) sees the warning would depend on which test
  files happen to share its worker.
* numpy <-> torch converters for graphs and arrays: the same inputs, made
  from a seed with numpy, go to both packages.
* `needs_cuda` marks a test that needs an NVIDIA GPU (a CUDA kernel has no
  CPU mode); it skips, with a reason, when CUDA is unavailable.  The check
  runs in a fixture, never at import time, so every test worker collects
  the same tests.
* `one_torch_thread` runs a test module with one torch intra-op thread.
  The suite runs in several worker processes on one machine; with torch's
  default pool (one thread per core) in each, the plain versions' many
  small parallel ops wait on descheduled threads and a module takes tens
  of times longer.  Results do not depend on the thread count.
* `update_errors` holds an optimizer's steps against a reference's by
  the update each leaf took from the common start, not by the values:
  AdamW moves an entry by about lr a step, far below a value's own size,
  so a bound relative to the values cannot see a missing or reversed
  step.
"""
from __future__ import annotations

import importlib
import warnings

import numpy as np
import pytest
import torch

CPU = torch.device("cpu")


def _import_reference(name: str):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return importlib.import_module(name)


_STREAM = _import_reference("repro.runtime.stream")
_SERVICE = _import_reference("repro.service")


def reference():
    """The JAX package's `repro.runtime.stream` module."""
    return _STREAM


def reference_service():
    """The JAX package's `repro.service` package (it imports the stream
    runtime, so the same warning is ignored)."""
    return _SERVICE


def to_port(jg, device=CPU):
    """A JAX `GraphBlocks` -> the port's `GraphBlocks` (same arrays)."""
    from repro_torch.core.graph import GraphBlocks

    return GraphBlocks.from_numpy(jg, jg.P, jg.Cn, jg.Cd, device=device)


def tensor_of(x, device=CPU) -> torch.Tensor:
    """A torch COPY of a jax/numpy array (jax buffers may be donated)."""
    return torch.from_numpy(np.array(x)).to(device)


def np_of(x) -> np.ndarray:
    """Host numpy view of a torch tensor or a jax array."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def assert_same_graph(tg, jg) -> None:
    """Exact equality of the four graph arrays and the capacities."""
    assert (tg.P, tg.Cn, tg.Cd) == (jg.P, jg.Cn, jg.Cd)
    a = tg.to_numpy()
    for f in ("nbr", "deg", "node_mask", "orig_id"):
        np.testing.assert_array_equal(a[f], np.asarray(getattr(jg, f)),
                                      err_msg=f)


@pytest.fixture(scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")


def needs_cuda(fn):
    """Mark a test `cuda` and skip it when no CUDA device is present.

    The test module must import `require_cuda` too, so pytest finds the
    fixture."""
    return pytest.mark.cuda(pytest.mark.usefixtures("require_cuda")(fn))


#: float tolerance of `assert_same_state` (PageRank: the JAX tests' bar
#: across backends)
FLOAT_ATOL = 2e-6


def host_state(x):
    """A comparable host form of a result of either package: tensors and
    jax arrays to numpy; graphs (anything with `.nbr`) to their four
    arrays; stream sessions (`.stats()`) to graph, coreness, labels and
    stats; NamedTuples and tuples element-wise (fields read by name, so a
    `StreamResult` is never unpacked); ints and None as they are."""
    if isinstance(x, torch.Tensor) or hasattr(x, "__array__") and not \
            isinstance(x, (tuple, list)) and not hasattr(x, "nbr"):
        return np.array(x.cpu() if isinstance(x, torch.Tensor) else x)
    if hasattr(x, "nbr") and hasattr(x, "deg"):
        return tuple(np.array(np_of(getattr(x, f)))
                     for f in ("nbr", "deg", "node_mask", "orig_id"))
    if hasattr(x, "stats") and callable(x.stats):
        return (host_state(x.g), host_state(x.core), host_state(x.labels),
                tuple(x.stats()))
    if hasattr(x, "_fields"):
        return tuple(host_state(getattr(x, f)) for f in x._fields)
    if isinstance(x, (tuple, list)):
        return tuple(host_state(v) for v in x)
    return x


def assert_same_state(a, b, what: str = "") -> None:
    """`host_state(a)` equals `host_state(b)`: integers and bools exactly,
    floats to `FLOAT_ATOL`."""
    a, b = host_state(a), host_state(b)
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, (what, a.shape, b.shape)
        if a.dtype.kind == "f" or b.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=0, atol=FLOAT_ATOL,
                                       err_msg=what)
        else:
            np.testing.assert_array_equal(a, b, err_msg=what)
    elif isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b), (what, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same_state(x, y, f"{what}[{i}]")
    else:
        assert a == b, (what, a, b)


def _np64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
    return np.asarray(x, np.float64)


def update_errors(got, want, start, grads, near: float, tol: float):
    """Leaf by leaf (lists of tensors or arrays, one order), the update
    `got - start` against the reference's `want - start` after
    `len(grads)` optimizer steps; `grads[s]` holds the reference's
    gradient leaves of step s.  An entry's error is |Δgot - Δwant| less
    one float32 ulp of its value per step (each step rounds the master
    once in either package).

    AdamW's step is lr · m̂ / (sqrt(v̂) + eps): an entry whose gradient
    at some step is within the gradients' own error of zero, `near` ×
    that step's largest |g| of the leaf, may take another step in the
    two packages, by up to 2 lr.  Such entries are "near"; the others
    must follow the reference closely.

    Returns (worst, near_worst, n_near_used, n_entries): `worst` the
    largest error of an entry that is not near, relative to its leaf's
    largest |Δwant|; `near_worst` the largest absolute error of a near
    entry; `n_near_used` how many near entries are further off than
    `tol` of that scale allows, so need the 2 lr allowance."""
    worst, near_worst, used, total = 0.0, 0.0, 0, 0
    steps = len(grads)
    for k, (a, b, s) in enumerate(zip(got, want, start)):
        a, b, s = _np64(a), _np64(b), _np64(s)
        assert a.shape == b.shape == s.shape, k
        err = np.abs((a - s) - (b - s)) - steps * np.spacing(
            np.maximum(np.abs(s), np.abs(b)).astype(np.float32)
        ).astype(np.float64)
        err = np.maximum(err, 0.0)
        scale = float(np.max(np.abs(b - s), initial=0.0)) or 1.0
        is_near = np.zeros(a.shape, bool)
        for g in grads:
            g = np.abs(_np64(g[k]))
            is_near |= g <= near * float(np.max(g, initial=0.0))
        far = err[~is_near]
        worst = max(worst, float(np.max(far, initial=0.0)) / scale)
        near_err = err[is_near]
        near_worst = max(near_worst, float(np.max(near_err, initial=0.0)))
        used += int(np.count_nonzero(near_err > tol * scale))
        total += a.size
    return worst, near_worst, used, total
