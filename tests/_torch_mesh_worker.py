"""Rank body and launcher of the multi-process tests of the port's mesh
runtime (`repro_torch.runtime.spmd` under `torch.distributed`'s gloo
backend, on the CPU).

`spawn_mesh(W, case, out_dir)` starts W processes
(`torch.multiprocessing.spawn`), each joining a gloo group of W ranks on
a free localhost port with a 60 s collective timeout, and waits for them
with a time limit: a rank that fails or hangs ends the test instead of
hanging the suite.  Each rank runs `run_case` on the graph and inputs in
`case` (a dict of numpy arrays) and writes its results to
``out_dir/rank{r}.npz``; `spawn_mesh` returns them, one dict per rank.

This module imports only torch, numpy and the port, so a rank starts in
a few seconds.
"""
from __future__ import annotations

import socket
import time
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch

#: seconds a whole multi-process job may take before it is killed
JOB_TIMEOUT = 240


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_case(case: dict) -> dict:
    """Every executor primitive on `case`, under overlap True and False,
    then one incremental plan update and coreness again (in this rank's
    process group, or alone at W = 1)."""
    from repro_torch.core.graph import GraphBlocks
    from repro_torch.core.updates import apply_updates_host
    from repro_torch.kernels import ops
    from repro_torch.runtime.spmd import SpmdExecutor

    g = GraphBlocks.from_numpy(case, int(case["P"]), int(case["Cn"]),
                               int(case["Cd"]), device="cpu")
    t = {k: torch.from_numpy(case[k]) for k in
         ("est", "f", "elig", "vis", "core", "roots", "ks", "est0", "cand")}
    out = {}
    for ov in (True, False):
        ex = SpmdExecutor(g, overlap=ov)
        p = f"ov{int(ov)}_"
        out[p + "W"] = np.asarray(ex.wm.W)
        core, steps = ex.coreness()
        out[p + "core"] = core.numpy()
        out[p + "core_steps"] = np.asarray(steps)
        out[p + "hindex"] = ex.hindex(t["est"]).numpy()
        out[p + "frontier"] = ex.frontier(t["f"], t["elig"], t["vis"]).numpy()
        out[p + "frontier_shared"] = ops.frontier_blocks(
            g, t["f"], t["elig"][:, 0].contiguous(), t["vis"],
            backend="ell_spmd", executor=ex).numpy()
        vis, steps = ex.k_reachable_batch(t["core"], t["roots"], t["ks"])
        out[p + "reach"], out[p + "reach_steps"] = vis.numpy(), np.asarray(
            steps)
        est, steps = ex.restricted_recompute(t["est0"], t["cand"])
        out[p + "rec"], out[p + "rec_steps"] = est.numpy(), np.asarray(steps)
    window = [tuple(int(x) for x in e) for e in case["window"]]
    g2 = apply_updates_host(g.clone(), window)
    ex.apply_updates(g2, window)
    core, steps = ex.coreness()
    out["updated_core"], out["updated_steps"] = core.numpy(), np.asarray(
        steps)
    out["plan_updates"] = np.asarray(ex.plan_updates)
    out["spmd_core"] = ops.coreness_blocks(g2, backend="ell_spmd").numpy()
    return out


def _rank(rank: int, W: int, port: int, case_path: str, out_dir: str):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=W,
        rank=rank, timeout=timedelta(seconds=60))
    try:
        with np.load(case_path) as z:
            case = dict(z)
        out = run_case(case)
        np.savez(Path(out_dir) / f"rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


def spawn_mesh(W: int, case: dict, out_dir: Path,
               timeout: float = JOB_TIMEOUT) -> list:
    """Run `run_case` on W gloo ranks; returns each rank's result dict.
    Raises if a rank fails or the job outlives `timeout` seconds (its
    processes are then killed)."""
    import torch.multiprocessing as mp

    out_dir = Path(out_dir)
    case_path = out_dir / "case.npz"
    np.savez(case_path, **case)
    ctx = mp.spawn(_rank, args=(W, _free_port(), str(case_path),
                                str(out_dir)),
                   nprocs=W, join=False)
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"the {W}-rank gloo job outlived {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(5)
    res = []
    for r in range(W):
        with np.load(out_dir / f"rank{r}.npz") as z:
            res.append(dict(z))
    return res
