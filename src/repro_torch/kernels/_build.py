"""Build and load the hand-written CUDA kernels (nvcc + ctypes).

Each ``csrc/<name>.cu`` has a plain C interface (``extern "C"``) and is
compiled on first use into its own shared library,

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/repro_torch_kernels/<name>-<hash>.so

named by a hash of the source, every shared header ``csrc/*.cuh`` and the
flags, so an edit to a source or a header rebuilds and an unchanged tree
reuses what is there.  `build_all` starts one nvcc per
source, all at once, and waits for them together.  Libraries are loaded
with ctypes; every pointer and the CUDA stream are passed as
``c_void_p``.  Nothing here includes PyTorch's headers, which keeps a
build to seconds.

Nothing is built or loaded at import time: the CPU tests import every
module of the package on a machine without nvcc.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
#: the checkout's build directory (listed in .gitignore)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-shared", "-Xcompiler",
                           "-fPIC")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: the kernel sources, by name (csrc/<name>.cu), with the argument types of
#: each one's C launch function `<name>_launch` (it returns a cudaError_t)
SOURCES = {
    # nbr, est, deg (or NULL), out, n_rows, ld, C, stream
    "ell_hindex": (_P, _P, _P, _P, _L, _I, _I, _P),
    # nbr, f, eligible, visited, deg (or NULL), out, n_rows, ld, C, R, stream
    "ell_frontier": (_P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _P),
    # nbr, field, deg (or NULL), out, n_rows, ld, C, stream
    "ell_cc": (_P, _P, _P, _P, _L, _I, _I, _P),
    "ell_pagerank": (_P, _P, _P, _P, _L, _I, _I, _P),
    # nbr, deg (or NULL), in0..in2, out0..out2, code0..code2, k, n_rows,
    # ld, C, stream
    "ell_multi": (_P, _P) + (_P,) * 6 + (_I,) * 4 + (_L, _I, _I, _P),
    # nbr, rows, deg (or NULL), the field's deg (or NULL), out, n_rows, ld,
    # C, stream
    "ell_triangles": (_P, _P, _P, _P, _P, _L, _I, _I, _P),
    # nbr, est, deg (or NULL), out, n_rows, ld, C, stream (the "count"
    # variant)
    "ell_hindex_count": (_P, _P, _P, _P, _L, _I, _I, _P),
    # nbr, rows, deg (or NULL), the field's deg (or NULL), out, n_rows, ld,
    # C, stream (the "allpairs" variant)
    "ell_allpairs": (_P, _P, _P, _P, _P, _L, _I, _I, _P),
    # dense adjacency, est, out, N, K, stream
    "kcore_hindex": (_P, _P, _P, _L, _I, _P),
    # dense adjacency, f, shared eligible, visited, out, N, R, stream
    "frontier": (_P, _P, _P, _P, _P, _L, _I, _P),
    # nbr, deg, field, ldeg, grp_rows, offsets, order, nbig, out, wide,
    # n_groups, ld, stream (the h-index merge of a hub-split graph)
    "mirror_hindex": (_P,) * 10 + (_L, _I, _P),
    # nbr, deg, node_mask, parent (scratch), out, n_rows, ld, stream (CC
    # labels by union-find)
    "cc_union": (_P,) * 5 + (_L, _I, _P),
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "on this machine")


def _library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):  # any source may include any
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


@functools.lru_cache(maxsize=None)
def build_all() -> Dict[str, Path]:
    """Compile every source that has no library yet, in parallel.

    Returns {name: path of the shared library}.  Raises with nvcc's
    output if any compile fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: _library_path(name) for name in SOURCES}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    procs = {}
    for name, path in todo.items():
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), tmp, path)
    failures = []
    for name, (proc, tmp, path) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed on csrc/{name}.cu:\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, path)  # atomic: no reader sees a partial file
    if failures:
        raise RuntimeError("\n".join(failures))
    return paths


@functools.lru_cache(maxsize=None)
def launcher(name: str):
    """The C launch function ``<name>_launch`` of ``csrc/<name>.cu``, with
    its argument and return types declared (built and loaded if needed)."""
    fn = getattr(ctypes.CDLL(str(build_all()[name])), f"{name}_launch")
    fn.argtypes = list(SOURCES[name])
    fn.restype = ctypes.c_int
    return fn


def launch(name: str, device, *args) -> None:
    """Call ``<name>_launch(*args, stream)`` on `device`'s current stream
    and raise if the launch was refused (a refused launch never runs, and
    no later synchronize reports it)."""
    with torch.cuda.device(device):  # launch on the tensors' card
        err = launcher(name)(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
