#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

Run from the root of a checkout, on a machine with one CUDA card and nvcc:

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero):

1. card: the `nvidia-smi` name and power limit; build all six CUDA
   kernels from `src/repro_torch/kernels/csrc` (one nvcc per source, in
   parallel).
2. kernel parity: each kernel against its plain PyTorch version on the
   card, on the DS1 graph's adjacency and on its rows shuffled, at K = Cd
   and at the degree bound — `ell_hindex` with est = degrees, random ints
   and the coreness; `ell_frontier` at R = 1, 8, 13; `ell_cc` with random
   ints and CC labels; `ell_pagerank` with PageRank contributions and
   random floats; `ell_multi` with ("hindex", "min", "sum") and each alone,
   also bit-equal to the standalone kernels; `ell_triangles` with
   rows = nbr.  Bit-equal, except the float sum: allclose(rtol=1e-5,
   atol=1e-9) against `torch.sum`'s order.
3. main path at the paper's DS1 size (`snap_like("DS1", 1.0, seed=7)`,
   BFS-partitioned into 8 blocks): static coreness and a 200-update
   `run_stream` (R = 8) through the kernels, held against the plain
   backend (same coreness, same superstep counts, same `StreamStats`) and
   a fresh recompute; both kernels' launch counts must be > 0.
4. analytics_ds1, the BlockProgram path on the same graph, through the
   kernels and held against the plain backend: connected components,
   PageRank (30 fixed supersteps; and tol = 1e-6), triangle counts, the
   coreness program, `fused_analytics` warm-started from them, and the
   same 200-update stream with CC labels maintained; CC and triangles
   also against scipy on the host.  All six kernels must launch.
5. scale: a 2^21-node random ELL graph (Cd = 32, ~256 MB of nbr): static
   coreness and a 64-update intra-block stream, then CC, PageRank and
   triangle counts, held the same way.
6. timing: each kernel and its plain version at the main path's shapes
   (`ell_hindex` at both: the stream's K = Cd and the static fixpoint's
   degree bound; the four combines at the analytics shapes, and
   `torch.sparse.mm` beside the sum), by CUDA events between 20
   back-to-back calls after warm-up, the median, beside the bytes bound
   at 3.35 TB/s.

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
#: published float32 rate of one H100 SXM outside the tensor cores (op/s),
#: the rate the integer compares of the triangle probes are counted at
SCALAR_OPS_PER_S = 67e12
#: the six kernels: name -> the wrapper's module under repro_torch.kernels
#: and the TPU kernel it replaces
KERNELS = {
    "ell_hindex": ("ell_hindex.hindex_ell",
                   "src/repro/kernels/ell_hindex.py:117"),
    "ell_frontier": ("ell_frontier.frontier_step_ell",
                     "src/repro/kernels/ell_frontier.py:107"),
    "ell_cc": ("ell_cc.neighbor_min_ell", "src/repro/kernels/ell_cc.py:102"),
    "ell_pagerank": ("ell_pagerank.neighbor_sum_ell",
                     "src/repro/kernels/ell_pagerank.py:66"),
    "ell_multi": ("ell_multi.neighbor_multi_ell",
                  "src/repro/kernels/ell_multi.py:100"),
    "ell_triangles": ("ell_triangles.neighbor_common_ell",
                      "src/repro/kernels/ell_triangles.py:167"),
}
#: the float sum's tolerance against the plain version (torch.sum adds in
#: another order); the ranks', after 30 supersteps of such sums
SUM_TOL = dict(rtol=1e-5, atol=1e-9)
RANK_TOL = dict(rtol=1e-4, atol=1e-9)
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
    parity.update(combine_parity(g, core_plain, dev))
    ups = sample_stream(g, DS1_UPDATES // 4, seed0=2)
    launches, hindex_split = _drive(g, ups, "main_path_ds1")
    launches_an, fields = _analytics(g, "analytics_ds1", core_plain, ups)
    scale_phase(dev)
    kernels = timing(g, core_plain, ups[:R], parity, launches, hindex_split)
    kernels += combine_timing(g, fields, parity, launches_an)
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


def combine_parity(g, core, dev):
    """The four combine kernels against their plain versions on the card,
    on the DS1 adjacency and its rows shuffled, at K = Cd and at the degree
    bound.  Returns {kernel name: max |kernel - plain| over all cases}."""
    import torch
    from repro_torch.core import connected_components, pagerank
    from repro_torch.core.algorithms import PageRankProgram
    from repro_torch.kernels import ops
    from repro_torch.kernels.ell_cc import (
        neighbor_min_ell, neighbor_min_ell_plain)
    from repro_torch.kernels.ell_hindex import hindex_ell
    from repro_torch.kernels.ell_multi import (
        neighbor_multi_ell, neighbor_multi_ell_plain)
    from repro_torch.kernels.ell_pagerank import (
        neighbor_sum_ell, neighbor_sum_ell_plain)
    from repro_torch.kernels.ell_triangles import (
        neighbor_common_ell, neighbor_common_ell_plain)

    gen = torch.Generator(device=dev).manual_seed(1)
    nbr, N, Cd = g.nbr, g.N, g.Cd
    shuffled = nbr.gather(
        1, torch.rand((N, Cd), generator=gen, device=dev).argsort(dim=1))
    labels = connected_components(g, backend="torch")
    rank = pagerank(g, tol=None, max_steps=30, backend="torch")
    ints = {"random": torch.randint(-5, N + 5, (N,), generator=gen,
                                    device=dev, dtype=torch.int32),
            "cc_labels": torch.where(g.node_mask, labels,
                                     torch.iinfo(torch.int32).max)}
    floats = {"pagerank_contrib": PageRankProgram._contrib(g.deg, rank),
              "random": torch.rand(N, generator=gen, device=dev)}
    adj = {"sorted": nbr, "shuffled": shuffled}
    Ks = {"K=Cd": None, "K=degree_bound": ops.degree_bound(g)}
    err = dict.fromkeys(("ell_cc", "ell_pagerank", "ell_multi",
                         "ell_triangles"), 0.0)
    alone = {"min": neighbor_min_ell, "sum": neighbor_sum_ell,
             "hindex": hindex_ell}
    cases = []
    for (an, nb), (kn, K) in ((a, k) for a in adj.items() for k in Ks.items()):
        for fn, f in ints.items():
            got, want = neighbor_min_ell(nb, f, K), neighbor_min_ell_plain(
                nb, f, K)
            if not torch.equal(got, want):
                raise AssertionError(f"ell_cc differs from plain: {an} {kn} "
                                     f"{fn}")
        for fn, f in floats.items():
            got, want = neighbor_sum_ell(nb, f, K), neighbor_sum_ell_plain(
                nb, f, K)
            err["ell_pagerank"] = max(err["ell_pagerank"],
                                      float((got - want).abs().max()))
            if not torch.allclose(got, want, **SUM_TOL):
                raise AssertionError(f"ell_pagerank not close to plain: {an} "
                                     f"{kn} {fn}")
        host = {"hindex": core, "min": ints["cc_labels"],
                "sum": floats["pagerank_contrib"]}
        for combines in (("hindex", "min", "sum"), ("hindex",), ("min",),
                         ("sum",)):
            fields = [host[c] for c in combines]
            got = neighbor_multi_ell(nb, fields, combines, K)
            want = neighbor_multi_ell_plain(nb, fields, combines, K)
            for c, f, g_, w in zip(combines, fields, got, want):
                if not torch.equal(g_, alone[c](nb, f, K)):
                    raise AssertionError(f"ell_multi {c} != standalone kernel:"
                                         f" {an} {kn} {combines}")
                ok = torch.allclose(g_, w, **SUM_TOL) if c == "sum" \
                    else torch.equal(g_, w)
                if not ok:
                    raise AssertionError(f"ell_multi {c} differs from plain: "
                                         f"{an} {kn} {combines}")
                if c == "sum":
                    err["ell_multi"] = max(err["ell_multi"],
                                           float((g_ - w).abs().max()))
        got = neighbor_common_ell(nb, nb, K)
        if not torch.equal(got, neighbor_common_ell_plain(nb, nb, K)):
            raise AssertionError(
                f"ell_triangles differs from plain: {an} {kn}")
        cases.append(f"{an}/{kn}")
    torch.cuda.synchronize()
    emit(phase="combine_parity", cases=cases, ints=sorted(ints),
         floats=sorted(floats), sum_tol=SUM_TOL, max_abs_err=err)
    return err


def _check_same_stream(a, b, what):
    import torch

    if not (torch.equal(a.core, b.core) and torch.equal(a.g.nbr, b.g.nbr)
            and torch.equal(a.g.deg, b.g.deg) and a.stats == b.stats):
        raise AssertionError(f"{what}: ell and plain streams differ: "
                             f"{a.stats} vs {b.stats}")


def _wrapper(name):
    """The wrapper function of kernel `name` (it carries `.launches`)."""
    import importlib

    mod, fn = KERNELS[name][0].split(".")
    return getattr(importlib.import_module(f"repro_torch.kernels.{mod}"), fn)


def _counted(fn, names=("ell_hindex", "ell_frontier")):
    """Run fn with every kernel's launch count set to 0 just before and
    read just after; returns (fn's result, {kernel: launches}).  Raises if
    a kernel of `names` never launched."""
    import torch

    for name in KERNELS:
        _wrapper(name).launches = 0
    out = fn()
    torch.cuda.synchronize()
    counts = {name: _wrapper(name).launches for name in names}
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
    _analytics(g, "analytics_scale_2^%d" % SCALE_LOG2_N)


def _close(a, b, what, tol=RANK_TOL):
    import torch

    if not torch.allclose(a, b, **tol):
        err = float((a - b).abs().max())
        raise AssertionError(f"{what}: ell and plain differ by {err}")


def analytics_path(gc, backend, core=None, ups=None):
    """The BlockProgram workloads on graph `gc` through one backend:
    connected components, PageRank (30 fixed supersteps) and triangle
    counts; with `core` (the coreness of `gc`) and `ups` also PageRank with
    tol = 1e-6, the coreness program, `fused_analytics` warm-started from
    it and the labels, and `run_stream` with CC maintenance, which updates
    `gc` in place, last.  Returns {result name: value, "seconds": host
    seconds of the whole path, ending in a synchronize}."""
    import torch
    from repro_torch.core import (
        connected_components, fused_analytics, pagerank, triangle_counts)
    from repro_torch.core.algorithms import CorenessBlockProgram
    from repro_torch.kernels import ops
    from repro_torch.runtime import run_stream

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = {}
    r["labels"], r["cc_steps"] = connected_components(
        gc, backend=backend, with_steps=True)
    r["rank"], r["pr_steps"] = pagerank(gc, tol=None, max_steps=30,
                                        backend=backend, with_steps=True)
    r["tri"] = triangle_counts(gc, backend=backend)
    if core is not None:
        r["rank_tol"], r["pr_tol_steps"] = pagerank(
            gc, tol=1e-6, backend=backend, with_steps=True)
        r["core"], r["core_steps"] = ops.run_block_program(
            gc, CorenessBlockProgram(), backend=backend, with_steps=True)
        r["fused"] = fused_analytics(gc, steps=30, backend=backend,
                                     init=(r["core"], r["labels"]))
        r["stream"] = run_stream(gc, core.clone(), ups, R=R,
                                 backend=backend, cc_labels=r["labels"])
    torch.cuda.synchronize()
    r["seconds"] = time.perf_counter() - t0
    return r


def _analytics(g, what, core=None, ups=None):
    """The BlockProgram workloads through the kernels, held against the
    same programs on the plain backend; each path runs on its own copy of
    `g`.  With `core` and `ups` (the DS1 phase) also the coreness program,
    `fused_analytics` warm-started from it and the CC labels, PageRank
    with a tolerance, the stream with CC maintenance, and scipy's host
    check.  Returns ({kernel: launches} of the ell run, {field name:
    tensor} for the timing phase)."""
    import torch
    from repro_torch.core import connected_components

    full = core is not None
    names = (tuple(KERNELS) if full
             else ("ell_cc", "ell_pagerank", "ell_triangles"))
    e, launches = _counted(
        lambda: analytics_path(g.clone(), "ell", core, ups), names)
    p = analytics_path(g.clone(), "torch", core, ups)
    for k in ("labels", "tri") + (("core",) if full else ()):
        if not torch.equal(e[k], p[k]):
            raise AssertionError(f"{what}: ell and plain {k} differ")
    for k in ("cc_steps", "pr_steps") + (("core_steps",) if full else ()):
        if e[k] != p[k]:
            raise AssertionError(f"{what}: {k} {e[k]} (ell) vs {p[k]}")
    if e["pr_steps"] != 30:
        raise AssertionError(f"{what}: {e['pr_steps']} PageRank supersteps")
    _close(e["rank"], p["rank"], f"{what} pagerank(tol=None)")
    line = dict(phase=what, cc_steps=e["cc_steps"],
                components=int(torch.unique(e["labels"][g.node_mask]).numel()),
                pr_steps=e["pr_steps"],
                triangles=int(e["tri"].sum()) // 3, launches=launches,
                path_seconds=e["seconds"], plain_path_seconds=p["seconds"])
    if full:
        _close(e["rank_tol"], p["rank_tol"], f"{what} pagerank(tol=1e-6)")
        mask = g.node_mask
        if not torch.equal(torch.where(mask, e["core"], 0), core):
            raise AssertionError(f"{what}: coreness program != coreness")
        for r in (e, p):  # fused == standalone, bit for bit, per backend
            fc, fl, fr = r["fused"]
            if not (torch.equal(fc, r["core"]) and torch.equal(fl, r["labels"])
                    and torch.equal(fr, r["rank"])):
                raise AssertionError(f"{what}: fused != standalone")
        _check_same_stream(e["stream"], p["stream"], what)
        st = e["stream"].stats
        if not (torch.equal(e["stream"].labels, p["stream"].labels)
                and st.cc_merges > 0 and st.cc_recomputes > 0):
            raise AssertionError(f"{what}: stream CC labels or counts: {st}")
        fresh = connected_components(e["stream"].g, backend="ell")
        if not torch.equal(fresh, e["stream"].labels):
            raise AssertionError(f"{what}: maintained labels != recompute")
        line.update(pr_tol_steps={"ell": e["pr_tol_steps"],
                                  "torch": p["pr_tol_steps"]},
                    core_steps=e["core_steps"],
                    stream_stats=st._asdict(),
                    host_check=_scipy_check(g, e["labels"], e["tri"], what))
    emit(**line)
    fields = {"labels": e["labels"], "rank": e["rank"],
              "core": e.get("core")}
    return launches, fields


def _scipy_check(g, labels, tri, what):
    """CC and triangles against scipy on the host, from the edge list:
    the same partition of the real nodes; per-node triangles diag(A^3)/2
    and the total trace(A^3)/6."""
    import numpy as np
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components as sp_cc

    nbr = g.nbr.cpu().numpy()
    rows, cols = np.nonzero(nbr >= 0)
    A = sp.csr_matrix((np.ones(len(rows)), (rows, nbr[rows, cols])),
                      shape=(g.N, g.N))
    _, sp_lab = sp_cc(A, directed=False)
    mask = g.node_mask.cpu().numpy()
    ours = labels.cpu().numpy()[mask]
    theirs = sp_lab[mask]
    pairs = len(set(zip(ours.tolist(), theirs.tolist())))
    if not pairs == len(set(ours.tolist())) == len(set(theirs.tolist())):
        raise AssertionError(f"{what}: CC partition differs from scipy")
    closed = np.asarray(A.multiply(A @ A).sum(axis=1)).ravel()  # diag(A^3)
    if not (np.array_equal(closed / 2, tri.cpu().numpy())
            and closed.sum() / 6 == int(tri.sum()) // 3):
        raise AssertionError(f"{what}: triangles differ from scipy")
    return {"components": pairs, "triangles": int(closed.sum() / 6)}


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


def combine_timing(g, fields, parity, launches):
    """The four combine kernels at the analytics shapes the runner gives
    them (K = None: every one of the Cd columns, PAD may sit anywhere),
    each beside its plain version and a bytes bound that counts every input
    once and every output once; `ell_pagerank` also beside
    `torch.sparse.mm` of the CSR adjacency by the field (the CSR is built
    outside the timed region).  `ell_triangles` also gets an operations
    bound: each element of a row probed into each neighbour's row by two
    binary searches over C entries, counted at the scalar float32 rate.
    Its `ms` is the launch alone on the rows sorted beforehand (inputs nbr
    and the sorted copy); `sort_ms` is the wrapper's key-and-sort of the
    rows and `wrapper_ms` the whole wrapper, sort and launch."""
    import math
    import warnings

    import torch
    from repro_torch.core.algorithms import INT32_MAX, PageRankProgram
    from repro_torch.kernels.ell_cc import (
        neighbor_min_ell, neighbor_min_ell_plain)
    from repro_torch.kernels.ell_multi import (
        neighbor_multi_ell, neighbor_multi_ell_plain)
    from repro_torch.kernels.ell_pagerank import (
        neighbor_sum_ell, neighbor_sum_ell_plain)
    from repro_torch.kernels.ell_triangles import (
        common_sorted_ell, neighbor_common_ell, neighbor_common_ell_plain)
    from repro_torch.kernels.ref import key_sort_rows

    N, Cd, nbr = g.N, g.Cd, g.nbr
    lab = torch.where(g.node_mask, fields["labels"], INT32_MAX)
    contrib = PageRankProgram._contrib(g.deg, fields["rank"])
    core = fields["core"]
    combines = ("hindex", "min", "sum")
    valid = nbr >= 0
    rows, cols = torch.nonzero(valid, as_tuple=True)
    with warnings.catch_warnings():  # CSR support is "beta" in PyTorch
        warnings.simplefilter("ignore", UserWarning)
        csr = torch.sparse_coo_tensor(
            torch.stack([rows, nbr[rows, cols].long()]),
            torch.ones(rows.numel(), device=nbr.device),
            (N, N)).to_sparse_csr()
    x = contrib[:, None]
    lib_ms = _time_ms(lambda: torch.sparse.mm(csr, x))
    sp_err = float((torch.sparse.mm(csr, x)[:, 0]
                    - neighbor_sum_ell(nbr, contrib)).abs().max())
    deg = valid.sum(dim=1)
    probes = int((deg * deg).sum()) * 2 * max(1, math.ceil(math.log2(Cd + 1)))
    nbr_b, vec = N * Cd * 4, N * 4
    keyed = key_sort_rows(nbr)  # the triangle wrapper's sorted copy, once
    runs = {
        "ell_cc": (lambda: neighbor_min_ell(nbr, lab),
                   lambda: neighbor_min_ell_plain(nbr, lab),
                   nbr_b + 2 * vec, 0),
        "ell_pagerank": (lambda: neighbor_sum_ell(nbr, contrib),
                         lambda: neighbor_sum_ell_plain(nbr, contrib),
                         nbr_b + 2 * vec, 0),
        "ell_multi": (
            lambda: neighbor_multi_ell(nbr, (core, lab, contrib), combines),
            lambda: neighbor_multi_ell_plain(nbr, (core, lab, contrib),
                                             combines),
            nbr_b + 6 * vec, 0),
        "ell_triangles": (lambda: common_sorted_ell(nbr, keyed),
                          lambda: neighbor_common_ell_plain(nbr, nbr),
                          2 * nbr_b + vec, probes),
    }
    if not torch.equal(common_sorted_ell(nbr, keyed),
                       neighbor_common_ell(nbr, nbr)):
        raise AssertionError("ell_triangles: launch alone != wrapper")
    tri_split = dict(sort_ms=_time_ms(lambda: key_sort_rows(nbr)),
                     wrapper_ms=_time_ms(lambda: neighbor_common_ell(nbr,
                                                                     nbr)))
    out, shapes = [], {}
    for name, (kern, plain, nbytes, ops_) in runs.items():
        ms, plain_ms = _time_pair(kern, plain)
        bytes_ms = _bound_ms(nbytes)
        ops_ms = ops_ / SCALAR_OPS_PER_S * 1e3
        shapes[name] = dict(ms=ms, plain_ms=plain_ms, bound_bytes=nbytes,
                            bound_ops=ops_)
        extra = tri_split if name == "ell_triangles" else {}
        shapes[name].update(extra)
        out.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": KERNELS[name][1], "launches": launches[name],
            "parity": "allclose" if name == "ell_pagerank" else "bit-equal",
            **({"parity_detail": "every output bit-equal to its standalone "
                "kernel; min and hindex bit-equal to plain; max_abs_err is "
                "the sum's against plain"} if name == "ell_multi" else {}),
            "max_abs_err": parity[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bound_bytes": nbytes, "bound_ops": ops_,
            "library_ms": lib_ms if name == "ell_pagerank" else None,
            **extra})
    emit(phase="combine_timing", order="plain,kernel,kernel,plain", N=N,
         Cd=Cd, K=None, valid_slots=int(valid.sum()), shapes=shapes,
         sparse_mm_ms=lib_ms, sparse_mm_max_abs_err_vs_kernel=sp_err)
    return out


if __name__ == "__main__":
    sys.exit(main())
