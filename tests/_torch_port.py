"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

* `reference()` imports the JAX package's stream runtime.  Importing
  `repro.runtime` raises a DeprecationWarning from `repro/runtime/spmd.py`
  (jax's shard_map move), which the suite's filterwarnings turn into an
  error; the import here runs with that warning ignored, so the port's
  tests can use the reference without touching it.
* numpy <-> torch converters for graphs and arrays: the same inputs, made
  from a seed with numpy, go to both packages.
* `needs_cuda` marks a test that needs an NVIDIA GPU (a CUDA kernel has no
  CPU mode); it skips, with a reason, when CUDA is unavailable.  The check
  runs in a fixture, never at import time, so every test worker collects
  the same tests.
"""
from __future__ import annotations

import warnings

import numpy as np
import pytest
import torch

CPU = torch.device("cpu")


def reference():
    """The JAX package's `repro.runtime.stream` module."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        import repro.runtime.stream as stream
    return stream


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


@pytest.fixture
def require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")


def needs_cuda(fn):
    """Mark a test `cuda` and skip it when no CUDA device is present.

    The test module must import `require_cuda` too, so pytest finds the
    fixture."""
    return pytest.mark.cuda(pytest.mark.usefixtures("require_cuda")(fn))
