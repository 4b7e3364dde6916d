#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

Run from the root of a checkout, on a machine with one CUDA card and nvcc:

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero):

1. card: the `nvidia-smi` name and power limit; build both CUDA kernels
   from `src/repro_torch/kernels/csrc` (one nvcc per source, in parallel).
2. kernel parity: each kernel against its plain PyTorch version on the
   card, bit-equal, on the DS1 graph's adjacency — `ell_hindex` with est =
   degrees, random ints and the final coreness, at K = Cd and at the
   degree bound, and on shuffled rows; `ell_frontier` at R = 1, 8, 13.
3. main path at the paper's DS1 size (`snap_like("DS1", 1.0, seed=7)`,
   BFS-partitioned into 8 blocks): static coreness and a 200-update
   `run_stream` (R = 8) through the kernels, held against the plain
   backend (same coreness, same superstep counts, same `StreamStats`) and
   a fresh recompute; each kernel's launch count must be > 0.
4. scale: a 2^21-node random ELL graph (Cd = 32, ~256 MB of nbr): static
   coreness and a 64-update intra-block stream, held the same way.
5. timing: each kernel and its plain version at the main path's shapes
   (`ell_hindex` at both: the stream's K = Cd and the static fixpoint's
   degree bound), by CUDA events between 20 back-to-back calls after
   warm-up, the median, beside the bytes bound at 3.35 TB/s.

Earlier lines are JSON objects; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.
With no CUDA device, or without the repo's `src/repro_torch` beside it,
the script exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

#: published HBM3 rate of one H100 SXM (bytes/s)
HBM_BYTES_PER_S = 3.35e12
DS1_UPDATES = 200   # 50 each: inter/intra inserts, inter/intra deletes
SCALE_LOG2_N = 21   # the scale phase's node count, 2**21
SCALE_UPDATES = 64  # intra-block updates of the scale stream
R = 8               # stream window width


def emit(**obj) -> None:
    print(json.dumps(obj), flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch" / "__init__.py").exists():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from the "
              "root of a checkout", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import _build

    dev = torch.device("cuda", 0)
    card = card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    emit(phase="build", seconds=time.perf_counter() - t0,
         sources=sorted(_build.SOURCES), card=card)

    g, core_plain = ds1_graph(dev)
    parity = kernel_parity(g, core_plain, dev)
    ups = sample_stream(g, DS1_UPDATES // 4, seed0=2)
    launches, hindex_split = _drive(g, ups, "main_path_ds1")
    scale_phase(dev)
    kernels = timing(g, core_plain, ups[:R], parity, launches, hindex_split)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def sample_stream(g, q: int, seed0: int, scenarios=("inter", "intra")):
    """q inserts and q deletes per scenario, as examples/kcore_dynamic.py
    builds them (seeds seed0, seed0+1, ... in that order)."""
    from repro_torch.core.updates import sample_deletions, sample_insertions

    ups, seed = [], seed0
    for sample in (sample_insertions, sample_deletions):
        for scen in scenarios:
            ups += sample(g, q, scen, seed=seed)
            seed += 1
    return ups


def ds1_graph(dev):
    """The DS1 graph on the card and its plain-backend coreness."""
    from repro_torch.core import build_blocks, coreness_with_stats
    from repro_torch.core.partition import node_bfs_partition
    from repro_torch.graphgen import snap_like

    t0 = time.perf_counter()
    edges = snap_like("DS1", 1.0, seed=7)
    n = int(edges.max()) + 1
    assign = node_bfs_partition(edges, n, 8, seed=1)
    g = build_blocks(edges, n, assign, P=8, deg_slack=64, device=dev)
    core, steps = coreness_with_stats(g, backend="torch")
    emit(phase="ds1_graph", n=n, m=int(len(edges)), N=g.N, Cd=g.Cd,
         max_degree=int(g.deg.max()), edge_cut=g.edge_cut(),
         plain_steps=steps, max_core=int(core.max()),
         host_seconds=time.perf_counter() - t0)
    return g, core


def kernel_parity(g, core, dev):
    """Every kernel against its plain version on the card, bit-equal.
    Returns {kernel name: max |kernel - plain| over all cases} (0)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.ell_frontier import (
        frontier_step_ell, frontier_step_ell_plain)
    from repro_torch.kernels.ell_hindex import hindex_ell, hindex_ell_plain

    gen = torch.Generator(device=dev).manual_seed(0)
    nbr, N, Cd = g.nbr, g.N, g.Cd
    shuffled = nbr.gather(
        1, torch.rand((N, Cd), generator=gen, device=dev).argsort(dim=1))
    ests = {
        "degrees": g.deg,
        "random": torch.randint(-2, Cd + 10, (N,), generator=gen,
                                device=dev, dtype=torch.int32),
        "coreness": core,
    }
    cases = [(f"{e}/K={k}", nbr, est, k) for e, est in ests.items()
             for k in (None, ops.degree_bound(g))]
    cases.append(("shuffled/random/K=Cd", shuffled, ests["random"], None))
    err = {"ell_hindex": 0, "ell_frontier": 0}
    for name, nb, est, K in cases:
        got, want = hindex_ell(nb, est, K=K), hindex_ell_plain(nb, est, K)
        torch.cuda.synchronize()
        e = int((got.long() - want.long()).abs().max())
        err["ell_hindex"] = max(err["ell_hindex"], e)
        if e or not torch.equal(got, want):
            raise AssertionError(f"ell_hindex differs from plain on {name}")
    for Rr, nb in ((1, nbr), (8, nbr), (13, nbr), (8, shuffled)):
        f, elig, vis = (torch.rand((N, Rr), generator=gen, device=dev) < p
                        for p in (0.2, 0.7, 0.2))
        got = frontier_step_ell(nb, f, elig, vis)
        want = frontier_step_ell_plain(nb, f, elig, vis)
        torch.cuda.synchronize()
        e = int((got != want).sum().clamp(max=1))
        err["ell_frontier"] = max(err["ell_frontier"], e)
        if not torch.equal(got, want):
            raise AssertionError(f"ell_frontier differs from plain at R={Rr}")
    emit(phase="kernel_parity", hindex_cases=[c[0] for c in cases],
         frontier_R=[1, 8, 13, "8/shuffled"], max_abs_err=err)
    return err


def _check_same_stream(a, b, what):
    import torch

    if not (torch.equal(a.core, b.core) and torch.equal(a.g.nbr, b.g.nbr)
            and torch.equal(a.g.deg, b.g.deg) and a.stats == b.stats):
        raise AssertionError(f"{what}: ell and plain streams differ: "
                             f"{a.stats} vs {b.stats}")


def _counted(fn):
    """Run fn with both kernels' launch counts set to 0 just before and
    read just after; returns (fn's result, {kernel: launches})."""
    import torch
    from repro_torch.kernels.ell_frontier import frontier_step_ell
    from repro_torch.kernels.ell_hindex import hindex_ell

    hindex_ell.launches = frontier_step_ell.launches = 0
    out = fn()
    torch.cuda.synchronize()
    counts = {"ell_hindex": hindex_ell.launches,
              "ell_frontier": frontier_step_ell.launches}
    if min(counts.values()) < 1:
        raise AssertionError(f"a kernel of the path never launched: {counts}")
    return out, counts


def _drive(g, ups, what):
    """Static coreness + run_stream through the kernels, held against the
    same path on the plain backend and a fresh recompute.  Each path runs
    on its own copy of `g`.  Returns the kernels' launch counts."""
    import torch
    from repro_torch.core import coreness, coreness_with_stats
    from repro_torch.kernels.ell_hindex import hindex_ell
    from repro_torch.runtime import run_stream

    def path(backend):
        gc = g.clone()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        core, steps = coreness_with_stats(gc, backend=backend)
        static = hindex_ell.launches  # the rest are the stream's (K = Cd)
        res = run_stream(gc, core, ups, R=R, backend=backend)
        torch.cuda.synchronize()
        return core, steps, res, time.perf_counter() - t0, static

    (core, steps, res, secs, static), counts = _counted(lambda: path("ell"))
    core_p, steps_p, res_p, secs_p, _ = path("torch")
    if steps != steps_p or not torch.equal(core, core_p):
        raise AssertionError(f"{what}: ell coreness differs from plain "
                             f"({steps} vs {steps_p} supersteps)")
    _check_same_stream(res, res_p, what)
    fresh = coreness(res.g, backend="torch")
    if not torch.equal(fresh, res.core):
        raise AssertionError(f"{what}: maintained coreness != recompute")
    hindex_split = {"static": static, "stream": counts["ell_hindex"] - static}
    emit(phase=what, static_steps=steps, max_core=int(core.max()),
         stream_stats=res.stats._asdict(), launches=counts,
         ell_hindex_launches=hindex_split,
         path_seconds=secs, plain_path_seconds=secs_p)
    return counts, hindex_split


def scale_phase(dev):
    from repro_torch.core import build_ell_random

    t0 = time.perf_counter()
    g = build_ell_random(2 ** SCALE_LOG2_N, Cd=32, seed=0, m_factor=4.0,
                         device=dev)
    ups = sample_stream(g, SCALE_UPDATES // 2, seed0=6, scenarios=("intra",))
    emit(phase="scale_graph", N=g.N, Cd=g.Cd, nbr_bytes=g.nbr.numel() * 4,
         max_degree=int(g.deg.max()), host_seconds=time.perf_counter() - t0)
    _drive(g, ups, "scale_random_2^%d" % SCALE_LOG2_N)


def _time_ms(fn, reps=20, warmup=3) -> float:
    """Median device milliseconds of one call, over `reps` calls.

    A CUDA event is recorded between consecutive calls.  The device is
    first held busy (`torch.cuda._sleep`) while the host queues all the
    calls, so the calls run back to back and each interval between two
    events is device time, not the host's launch overhead."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    torch.cuda._sleep(100_000_000)  # ~50 ms of device time
    ev[0].record()
    for i in range(reps):
        fn()
        ev[i + 1].record()
    ev[-1].synchronize()
    return statistics.median(ev[i].elapsed_time(ev[i + 1])
                             for i in range(reps))


def _bound_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def _time_pair(kernel, plain):
    """(kernel ms, plain ms) on one card, timed plain, kernel, kernel,
    plain; each is the smaller of its two medians."""
    p1, k1, k2, p2 = (_time_ms(fn) for fn in (plain, kernel, kernel, plain))
    return min(k1, k2), min(p1, p2)


def timing(g, core, window, parity, launches, hindex_split):
    """The kernel line: each kernel and its plain version at the main
    path's shapes.

    `ell_hindex` runs at two shapes.  The stream's clamped recompute
    (most launches) passes K = None: C = Cd columns, exact for any slot
    order, so every column must be read; timed with est = the coreness.
    The static fixpoint passes K = the degree bound (est = degrees there):
    its bound counts, besides the first C columns the kernel reads, what a
    left-filled row needs — its valid slots and the first PAD after them.
    The entry's own numbers are the recompute shape's.  `ell_frontier` is
    timed at the first hop of the stream's first window.  Bounds count
    every input read once and the output written once."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.ell_frontier import (
        frontier_step_ell, frontier_step_ell_plain)
    from repro_torch.kernels.ell_hindex import (
        columns, hindex_ell, hindex_ell_plain)

    N, Cd, nbr = g.N, g.Cd, g.nbr
    io = N * 4 + N * 4  # est read once, out written once
    shapes = []
    for shape, est, K, n in (
            ("stream recompute: K=None, est=coreness", core, None,
             hindex_split["stream"]),
            ("static fixpoint: K=degree_bound, est=degrees", g.deg,
             ops.degree_bound(g), hindex_split["static"])):
        C = columns(Cd, K)
        ms, plain_ms = _time_pair(lambda: hindex_ell(nbr, est, K=K),
                                  lambda: hindex_ell_plain(nbr, est, K))
        row_valid = (nbr[:, :C] >= 0).sum(dim=1)
        s = {"shape": shape, "C": C, "launches": n, "ms": ms,
             "plain_ms": plain_ms, "valid_slots": int(row_valid.sum()),
             "bound_bytes": N * C * 4 + io}
        s["bound_ms"] = _bound_ms(s["bound_bytes"])
        if C < Cd:
            left = int((row_valid + 1).clamp(max=C).sum()) * 4 + io
            s["bound_bytes_left_filled"] = left
            s["bound_ms_left_filled"] = _bound_ms(left)
        shapes.append(s)

    us = torch.tensor([u for u, _, _ in window], device=g.device)
    vs = torch.tensor([v for _, v, _ in window], device=g.device)
    ks = torch.minimum(core[us], core[vs])
    elig = ((core[:, None] == ks[None, :]) & g.node_mask[:, None]).contiguous()
    roots = torch.zeros((N, R), dtype=torch.bool, device=g.device)
    roots[us, torch.arange(R, device=g.device)] = True
    roots[vs, torch.arange(R, device=g.device)] = True
    f = (roots & elig).contiguous()
    vis = f.clone()
    # nbr slots this data needs, in slot order: none for a row that needs
    # no column; up to the slot where its last needed column is first hit;
    # all Cd when a needed column is never hit (PAD may sit anywhere)
    need = elig & ~vis
    hits = f[nbr.clamp(min=0).long()] & (nbr >= 0)[:, :, None]  # (N, Cd, R)
    first = hits.to(torch.int32).argmax(dim=1) + 1
    stop = torch.where(hits.any(dim=1), first, torch.full_like(first, Cd))
    slots = int(torch.where(need, stop, 0).amax(dim=1).sum())
    f_bytes = 4 * N * R + slots * 4  # eligible, visited, f, out; nbr slots
    del hits
    fk, fp = _time_pair(lambda: frontier_step_ell(nbr, f, elig, vis),
                        lambda: frontier_step_ell_plain(nbr, f, elig, vis))
    emit(phase="timing", order="plain,kernel,kernel,plain",
         hindex_shapes=shapes,
         frontier_shape=dict(N=N, Cd=Cd, R=R,
                             rows_needing=int(need.any(dim=1).sum()),
                             nbr_slots_needed=slots, ms=fk, plain_ms=fp))

    def entry(name, replaces, ms, plain_ms, nbytes, **extra):
        return {"name": name, "route": "cuda",
                "source": f"src/repro_torch/kernels/csrc/{name}.cu",
                "replaces": replaces, "launches": launches[name],
                "parity": "bit-equal", "max_abs_err": parity[name],
                "ms": ms, "plain_ms": plain_ms, "bound_ms": _bound_ms(nbytes),
                "bound_by": "bytes", "bound_bytes": nbytes,
                "library_ms": None, **extra}

    h = shapes[0]
    return [
        entry("ell_hindex", "src/repro/kernels/ell_hindex.py:117", h["ms"],
              h["plain_ms"], h["bound_bytes"], shapes=shapes),
        entry("ell_frontier", "src/repro/kernels/ell_frontier.py:107", fk, fp,
              f_bytes),
    ]


if __name__ == "__main__":
    sys.exit(main())
