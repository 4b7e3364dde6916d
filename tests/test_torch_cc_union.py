"""Connected-component labels by union-find (`kernels.cc_union`).

`union_find_labels` gives each real row its component's least padded id
and -1 to a padding row: what `core.algorithms.connected_components`
gives by min-label propagation.  On the CPU it runs its plain version
(hooking and pointer jumping to a fixpoint), held here to
`connected_components` on:

* a path with ascending, descending and shuffled ids (its depth is its
  length, the propagation's worst case);
* many components, isolated nodes and padding rows in several blocks;
* rows with a PAD slot in the middle of their valid slots;
* rows longer than 64 slots (the kernel's whole-warp rows) beside short
  ones, with and without such a PAD;
* a graph after `migrate_vertices`;
* a small random geometric graph (points in the unit square, an edge
  within 0.55 * sqrt(ln n / n)), the stream cell's kind of graph.

On the card (marker `cuda`, skipped without one) `csrc/cc_union.cu` is
held, bit for bit, to the plain version and to `connected_components` on
the same graphs and on a random geometric graph of 2^20 points, over 20
launches each (the order of its atomics varies from launch to launch);
and a `StreamSession` keeping labels launches it once a window with a
delete (its plain version on the plain backend, "torch"), reads nothing
back to the host while it runs, counts one pass in `cc_steps`, and under
a profiler holds the kernel's launches inside its `bladyg.cc` span.  Nothing here imports JAX.
"""
from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from repro_torch.analysis import entrypoints as E
from repro_torch.core import algorithms, kcore
from repro_torch.core.graph import GraphBlocks, build_blocks, migrate_vertices
from repro_torch.kernels.cc_union import (
    union_find_labels, union_find_labels_plain)
from repro_torch.runtime.stream import StreamSession

SEED = 2**31 + 41
DEV = torch.device("cuda")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")


def spatial_edges(n: int, seed: int, device="cpu") -> torch.Tensor:
    """(m, 2) int64 edges of n points uniform in the unit square, an edge
    within r = 0.55 * sqrt(ln n / n), on `device`: the points binned into
    cells at least r wide, each pair looked up in its 3 x 3 cells.  Ids
    are a random permutation of the points, so they carry no position."""
    gen = torch.Generator(device=device).manual_seed(seed)
    xy = torch.rand((n, 2), generator=gen, device=device,
                    dtype=torch.float64)
    r = 0.55 * math.sqrt(math.log(n) / n)
    k = max(1, int(1 / r))
    cell = (xy * k).long().clamp(max=k - 1)
    cid = cell[:, 0] * k + cell[:, 1]
    order = torch.argsort(cid)
    xy, cell = xy[order], cell[order]
    start = torch.searchsorted(cid[order],
                               torch.arange(k * k + 1, device=device))
    ids = torch.randperm(n, generator=gen, device=device)
    out = []
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            cx, cy = cell[:, 0] + dx, cell[:, 1] + dy
            inside = (cx >= 0) & (cx < k) & (cy >= 0) & (cy < k)
            c = (cx * k + cy).clamp(0, k * k - 1)
            lo = start[c]
            cnt = torch.where(inside, start[c + 1] - lo, 0)
            i = torch.repeat_interleave(torch.arange(n, device=device), cnt)
            first = (cnt.cumsum(0) - cnt)[i]
            j = lo[i] + torch.arange(i.numel(), device=device) - first
            near = (i < j) & (((xy[i] - xy[j]) ** 2).sum(1) < r * r)
            out.append(torch.stack([ids[i[near]], ids[j[near]]], 1))
    return torch.cat(out)


def ell_graph(edges: torch.Tensor, n: int, pad_rows: int = 0) -> GraphBlocks:
    """One block of the n nodes followed by `pad_rows` padding rows, built
    on the edges' device: rows sorted, PAD last, Cd the largest degree."""
    dev = edges.device
    src = torch.cat([edges[:, 0], edges[:, 1]])
    dst = torch.cat([edges[:, 1], edges[:, 0]])
    key = torch.sort(src * n + dst).values
    src, dst = key // n, key % n
    deg = torch.bincount(src, minlength=n)
    Cd = max(1, int(deg.max()))
    N = n + pad_rows
    pos = torch.arange(src.numel(), device=dev) - (deg.cumsum(0) - deg)[src]
    nbr = torch.full((N, Cd), -1, dtype=torch.int32, device=dev)
    nbr[src, pos] = dst.to(torch.int32)
    deg = torch.cat([deg, deg.new_zeros(pad_rows)]).to(torch.int32)
    real = torch.arange(N, device=dev) < n
    return GraphBlocks(nbr=nbr, deg=deg, node_mask=real,
                       orig_id=torch.where(real, torch.arange(N, device=dev),
                                           -1).to(torch.int32),
                       P=1, Cn=N, Cd=Cd)


def _path(order):
    order = np.asarray(order)
    edges = np.stack([order[:-1], order[1:]], 1)
    n = len(order)
    return build_blocks(edges, n, np.zeros(n, np.int64), 1, node_slack=5,
                        device="cpu")


def _components(rng):
    """Cliques, paths and stars of several sizes, isolated nodes among
    them, dealt into three blocks with spare rows."""
    n, edges, at = 300, [], 0
    while at < n - 20:
        size = int(rng.integers(1, 12))
        nodes = np.arange(at, min(at + size, n))
        kind = rng.integers(3)
        if kind == 0:
            edges += [(a, b) for a in nodes for b in nodes if a < b]
        elif kind == 1:
            edges += list(zip(nodes[:-1], nodes[1:]))
        else:
            edges += [(nodes[0], b) for b in nodes[1:]]
        at += size + int(rng.integers(0, 3))  # some nodes stay isolated
    perm = rng.permutation(n)
    edges = perm[np.asarray(edges)]
    return build_blocks(edges, n, rng.integers(0, 3, n), 3, node_slack=7,
                        device="cpu")


def _mid_row_pads(g):
    """`g` with a PAD put in the middle of every row that has two valid
    slots or more and a spare column: its later slots shift right."""
    nbr = g.nbr.clone()
    for u in range(g.N):
        d = int(g.deg[u])
        if 2 <= d < g.Cd:
            k = d // 2
            nbr[u, k + 1:d + 1] = g.nbr[u, k:d]
            nbr[u, k] = -1
    assert bool(((nbr[:, :-1] < 0) & (nbr[:, 1:] >= 0)).any())
    return GraphBlocks(nbr=nbr, deg=g.deg, node_mask=g.node_mask,
                       orig_id=g.orig_id, P=g.P, Cn=g.Cn, Cd=g.Cd)


def _migrated(rng):
    g = _components(rng)
    real = np.flatnonzero(g.node_mask.numpy())
    moves = [(int(u), (int(u) // g.Cn + 1) % g.P)
             for u in rng.choice(real, 6, replace=False)]
    g2, _ = migrate_vertices(g, moves)
    return g2


def _hubs(rng):
    """Hubs of 65, 130 and 300 neighbours among short rows (a warp holds
    rows of both kinds), two components and isolated nodes."""
    n = 600
    perm = rng.permutation(n)
    edges = [(perm[i], perm[i + 1]) for i in range(0, 400) if i % 50]
    for hub, d in ((perm[10], 65), (perm[200], 130), (perm[450], 300)):
        edges += [(hub, int(v)) for v in rng.choice(n, d, replace=False)
                  if v != hub]
    return build_blocks(np.asarray(edges), n, rng.integers(0, 2, n), 2,
                        node_slack=3, device="cpu")


def _spatial(n):
    return ell_graph(spatial_edges(n, SEED), n, pad_rows=9)


CASES = {
    "path_ascending": lambda rng: _path(np.arange(400)),
    "path_descending": lambda rng: _path(np.arange(400)[::-1]),
    "path_shuffled": lambda rng: _path(rng.permutation(400)),
    "components": _components,
    "mid_row_pads": lambda rng: _mid_row_pads(_components(rng)),
    "migrated": _migrated,
    "hubs": _hubs,
    "hubs_mid_row_pads": lambda rng: _mid_row_pads(_hubs(rng)),
    "spatial": lambda rng: _spatial(2048),
}


def _graph(name):
    return CASES[name](np.random.default_rng(SEED))


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_equals_propagation(name):
    g = _graph(name)
    want = algorithms.connected_components(g)
    got = union_find_labels(g.nbr, g.deg, g.node_mask)
    assert got.dtype == torch.int32
    assert torch.equal(got, want)
    assert torch.equal(union_find_labels_plain(g.nbr, g.deg, g.node_mask),
                       want)
    # padding rows are -1, every real row names a real row of its own
    # component at or below itself
    assert bool((got[~g.node_mask] == -1).all())
    ids = torch.arange(g.N, dtype=torch.int32)
    assert bool((got[g.node_mask] <= ids[g.node_mask]).all())


def test_cpu_tensors_launch_nothing():
    g = _graph("components")
    before = union_find_labels.launches
    union_find_labels(g.nbr, g.deg, g.node_mask)
    assert union_find_labels.launches == before


@pytest.mark.parametrize("bad", ["no_deg", "short_mask", "int_mask"])
def test_bad_arguments_raise(bad):
    g = _graph("components")
    deg, mask = g.deg, g.node_mask
    if bad == "no_deg":
        deg = None
    elif bad == "short_mask":
        mask = mask[1:]
    else:
        mask = mask.to(torch.int32)
    with pytest.raises(ValueError):
        union_find_labels(g.nbr, deg, mask)


def test_plain_reads_are_sync_spans():
    """Each round's test in the plain version is a host read, and only
    those: as many as `bladyg.sync` spans."""
    from torch.profiler import ProfilerActivity, profile

    g = _graph("path_shuffled")
    with E.count_host_reads("cpu") as box:
        union_find_labels(g.nbr, g.deg, g.node_mask)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        union_find_labels(g.nbr, g.deg, g.node_mask)
    syncs = [e for e in prof.profiler.kineto_results.events()
             if e.name() == "bladyg.sync"]
    assert len(syncs) == box.count > 0


# ---- on the card -----------------------------------------------------------

#: the card cases: the CPU's, and a random geometric graph of 2^20 points
CARD_CASES = sorted(CASES) + ["spatial_2^20"]
REPEATS = 20


@pytest.mark.cuda
@pytest.mark.usefixtures("require_cuda")
@pytest.mark.parametrize("name", CARD_CASES)
def test_kernel_equals_plain_and_propagation(name):
    if name == "spatial_2^20":
        n = 2**20
        g = ell_graph(spatial_edges(n, SEED, DEV), n, pad_rows=9)
    else:
        c = _graph(name)
        g = GraphBlocks(nbr=c.nbr.to(DEV), deg=c.deg.to(DEV),
                        node_mask=c.node_mask.to(DEV),
                        orig_id=c.orig_id.to(DEV), P=c.P, Cn=c.Cn, Cd=c.Cd)
    want = algorithms.connected_components(g)
    plain = union_find_labels_plain(g.nbr, g.deg, g.node_mask)
    assert torch.equal(plain, want)
    before = union_find_labels.launches
    for _ in range(REPEATS):
        got = union_find_labels(g.nbr, g.deg, g.node_mask)
        assert torch.equal(got, want)
    torch.cuda.synchronize()
    assert union_find_labels.launches == before + REPEATS


@pytest.mark.cuda
@pytest.mark.usefixtures("require_cuda")
@pytest.mark.parametrize("backend", ["auto", "torch"])
def test_session_recompute_launches_once_and_reads_nothing(backend):
    """A session keeping labels on the card: each window with a delete
    adds 1 to `cc_steps` and launches the kernel once ("auto"), or runs
    the plain version and launches nothing (the plain backend, "torch");
    the kernel's recompute reads nothing back; the labels equal
    `connected_components` after every window."""
    n = 2**14
    edges = spatial_edges(n, SEED, DEV)
    g = ell_graph(edges, n, pad_rows=9)
    core = kcore.coreness(g)
    sess = StreamSession(g, core, R=8, backend=backend,
                         cc_labels=algorithms.connected_components(g))
    e = edges.cpu().numpy()
    rng = np.random.default_rng(SEED)
    per_window = 1 if backend == "auto" else 0
    for k in range(4):
        picks = rng.choice(len(e), 4, replace=False)
        window = [(int(e[i, 0]), int(e[i, 1]), -1) for i in picks]
        e = np.delete(e, picks, axis=0)
        launches, steps = union_find_labels.launches, sess.cc_steps
        sess.apply_window(window)
        assert union_find_labels.launches == launches + per_window
        assert sess.cc_steps == steps + 1
        assert torch.equal(sess.labels,
                           algorithms.connected_components(sess.g))
    if backend != "auto":
        return
    torch.cuda.synchronize()
    with E.count_host_reads(DEV) as box:
        sess._recompute_labels(sess.g)
    torch.cuda.synchronize()
    assert box.count == 0
    assert torch.equal(sess.labels, algorithms.connected_components(sess.g))


@pytest.mark.cuda
@pytest.mark.usefixtures("require_cuda")
def test_cc_span_holds_the_recompute_kernels():
    """Under a profiler the session's `bladyg.cc` span waits for the
    recompute it launched: the kernel's three launches run inside it on
    the device's timeline, as the benchmark's `cc_ms_per_window` and
    `cc_roofline` read them."""
    from torch.profiler import ProfilerActivity, profile

    n = 2**16
    edges = spatial_edges(n, SEED, DEV)
    g = ell_graph(edges, n, pad_rows=9)
    sess = StreamSession(g, kcore.coreness(g), R=8,
                         cc_labels=algorithms.connected_components(g))
    e = edges[:4].tolist()
    sess.apply_window([(a, b, -1) for a, b in e[:2]])  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sess.apply_window([(a, b, -1) for a, b in e[2:]])
        torch.cuda.synchronize()
    events = list(prof.profiler.kineto_results.events())
    (s, t), = [(x.start_ns(), x.start_ns() + x.duration_ns())
               for x in events if x.name() == "bladyg.cc"]
    kernels = [(x.start_ns(), x.start_ns() + x.duration_ns())
               for x in events if "cc_" in x.name()
               and x.name().split("::")[-1].startswith(
                   ("cc_init_kernel", "cc_hook_kernel", "cc_label_kernel"))]
    assert len(kernels) == 3
    assert all(s <= a <= b <= t for a, b in kernels)
