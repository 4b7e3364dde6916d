"""The h-index merge kernel of a hub-split graph on the card.

`kernels.mirror_hindex.hindex_mirror` launches `csrc/mirror_hindex.cu` on
CUDA tensors.  Every test here holds it, bit for bit, against the plain
merge (`hindex_mirror_plain`, run on the CPU over the plan's
`group_layout`) and against the brute-force h-index of each group's
whole value multiset, and checks that rows outside every group pass
through:

* the skewed split graphs at thresholds 8, 12 and 16, and a graph whose
  two hubs' logical degrees lie more than 100x apart (warp and CTA
  groups);
* groups whose h climbs past the CTA's first window of thresholds, so
  `hindex_mirror.wide_groups` grows by exactly those groups, and groups
  whose h ends on a window's top;
* groups holding replica rows that deletes left empty;
* field values below 1 and past each group's logical degree;
* a `MirrorStream` and `fused_analytics` on the card, against the same
  on the CPU: the kernel launches;
* a mirrored coreness on "ell", whose h-index combine skips the live group
  rows (`skip_group_rows`): its coreness and steps equal the "torch"
  backend's on a plan as split, after an on-line split, after deletes
  that empty a replica, after `grow_plan` and with no group row at row 0;
  the kernel writes every row skipped; a `MirrorStream` over windows of
  splits, inserts and deletes keeps the CPU's core, labels and
  `refresh_steps` window by window; the skip counters read one run a
  refresh and the plan's live group rows;
* a `MirrorStream` whose refresh warm-starts from each window's bound
  (`kcore_dynamic.window_core_bound`): on the card as on the CPU, window
  by window, in core, `refresh_steps` and `warm_refreshes`, a grow
  refreshing cold between windows.

The min and sum merges, which read the same group layout, are held on the
card against the CPU's, bit for bit, and against their own repeat.

Graphs are made by the port's own functions, and nothing here imports JAX.
Every test needs an NVIDIA GPU (marker `cuda`) and skips without one.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro_torch.core as tcore
from repro_torch.core import algorithms as talg
from repro_torch.core import hub_split as ths
from repro_torch.graphgen.simple import barabasi_albert
from repro_torch.kernels import ops
from repro_torch.core.graph import grow_blocks
from repro_torch.kernels.mirror_hindex import (
    WARP_TOP, group_layout, hindex_mirror, skip_group_rows)
from repro_torch.runtime.stream import MirrorStream

pytestmark = pytest.mark.cuda

THRESHOLDS = [8, 12, 16]
#: the top of the CTA's first window of thresholds in csrc/mirror_hindex.cu:
#: 1 + kReg + kCtaBins
CTA_WINDOW_TOP = 1 + 4 + 4096
DEV = torch.device("cuda")


@pytest.fixture(autouse=True)
def require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")


def _skewed_edges(n, seed, threshold):
    """A Barabasi-Albert skew plus two planted hubs."""
    edges = {(0, v) for v in range(1, 1 + threshold * 4)}
    edges |= {(1, v) for v in range(2 + threshold * 4, 2 + threshold * 5)}
    for u, v in barabasi_albert(n, 3, seed=seed):
        if u != v:
            edges.add((min(u, v), max(u, v)))
    return np.array(sorted(edges))


def _star_edges(n, seed, hubs):
    """A sparse random graph plus hub h joined to `d` others, for each
    (h, d) of `hubs`."""
    rng = np.random.default_rng(seed)
    e = {tuple(sorted(map(int, p))) for p in rng.integers(0, n, (n, 2))}
    for h, d in hubs:
        others = np.setdiff1d(np.arange(n), [x for x, _ in hubs])
        e |= {(min(h, int(v)), max(h, int(v)))
              for v in rng.choice(others, d, replace=False)}
    return np.array(sorted((u, v) for u, v in e if u != v))


def _split(edges, n, P, threshold, slack, seed=0):
    assign = np.random.default_rng(seed).integers(0, P, n)
    return ths.build_split_blocks(edges, n, assign, P, threshold,
                                  node_slack=slack, device="cpu")


def _on(g2, plan, dev):
    """The graph and plan with every tensor on `dev`."""
    g = dataclasses.replace(g2, **{f: getattr(g2, f).to(dev) for f in (
        "nbr", "deg", "node_mask", "orig_id")})
    p = dataclasses.replace(plan, **{f: getattr(plan, f).to(dev)
                                     for f in ths.MirrorPlan.ARRAYS})
    return g, p


def _brute(g2, plan, field):
    """{primary: h-index of its group's values} by sorting them."""
    nbr, deg, f = g2.nbr.numpy(), g2.deg.numpy(), field.numpy()
    out = {}
    for h, rows in ths.groups_of(plan).items():
        vals = np.sort(np.concatenate(
            [f[nbr[r, :deg[r]]] for r in rows]))[::-1]
        out[h] = int(np.sum(vals >= np.arange(1, len(vals) + 1)))
    return out


def _check(g2, plan, field, red=None):
    """The kernel against the plain merge and the brute force; returns
    the merged values and the brute-force h per group."""
    if red is None:
        red = torch.from_numpy(np.random.default_rng(1).integers(
            -3, 50, g2.N).astype(np.int32))
    gd, pd_ = _on(g2, plan, DEV)
    got = hindex_mirror(red.to(DEV), field.to(DEV), gd.nbr, gd.deg,
                        pd_).cpu()
    want = ops._mirror_merge(red, field, g2.nbr, plan, "hindex")
    assert torch.equal(got, want)
    brute = _brute(g2, plan, field)
    groups = ths.groups_of(plan)
    for h, rows in groups.items():
        assert {int(got[r]) for r in rows} == {brute[h]}, h
    off = torch.ones(g2.N, dtype=torch.bool)
    off[[r for rows in groups.values() for r in rows]] = False
    assert torch.equal(got[off], red[off])
    return got, brute


@pytest.mark.parametrize("threshold", THRESHOLDS)
def test_kernel_equals_plain_on_split_graphs(threshold):
    g2, plan = _split(_skewed_edges(110, 3, threshold), 110, 8, threshold,
                      32)
    rng = np.random.default_rng(threshold)
    for lo, hi in ((-2, plan.Km + 6), (-3, 3 * plan.Km), (0, 4)):
        _check(g2, plan, torch.from_numpy(
            rng.integers(lo, hi, g2.N).astype(np.int32)))


@pytest.mark.parametrize("threshold", [4, 8])
def test_kernel_with_degrees_100x_apart(threshold):
    """Hubs of 1,500 and 12 neighbours: the first a CTA's group, the
    second (and the skew's) a warp's; the result is the same either way."""
    n = 1700
    rng = np.random.default_rng(2)
    e = {tuple(sorted(map(int, p))) for p in rng.integers(0, n, (2 * n, 2))}
    e |= {(0, v) for v in rng.choice(np.arange(2, n), 1500, replace=False)}
    e |= {(1, v) for v in rng.choice(np.arange(2, n), 12, replace=False)}
    edges = np.array(sorted((u, v) for u, v in e if u != v))
    g2, plan = _split(edges, n, 4, threshold, 600)
    top = {h: int(plan.ldeg[h]) for h in ths.groups_of(plan)}
    assert max(top.values()) > WARP_TOP >= min(top.values())
    assert max(top.values()) >= 100 * min(top.values())
    lay = group_layout(plan)
    assert int(lay.nbig) == sum(d > WARP_TOP for d in top.values())
    for hi in (40, 2 * 1500):
        _check(g2, plan, torch.from_numpy(
            rng.integers(-3, hi, g2.N).astype(np.int32)))


def test_kernel_past_the_first_window():
    """Groups whose h reaches the CTA's first window top (4,101) take
    further windows: `wide_groups` grows by exactly the groups of logical
    degree past 4,101 whose h is at least 4,101; h ending one below the
    window top, on it, at 5,000 and at the group's whole degree."""
    n = 9500
    edges = _star_edges(n, 5, [(0, 5000), (1, 4200), (2, 9000), (3, 300)])
    g2, plan = _split(edges, n, 4, 64, 120)
    top = {h: int(plan.ldeg[h]) for h in ths.groups_of(plan)}
    assert sum(d > CTA_WINDOW_TOP for d in top.values()) == 3
    rng = np.random.default_rng(7)
    fields = [rng.integers(-3, 12000, g2.N)] + [
        np.full(g2.N, v) for v in (CTA_WINDOW_TOP - 1, CTA_WINDOW_TOP, 5000,
                                   10 ** 6, 0, -5)]
    for f in fields:
        before = int(hindex_mirror.wide_groups)
        _, brute = _check(g2, plan, torch.from_numpy(f.astype(np.int32)))
        wide = sum(top[h] > CTA_WINDOW_TOP and brute[h] >= CTA_WINDOW_TOP
                   for h in top)
        assert int(hindex_mirror.wide_groups) - before == wide


def test_kernel_over_replicas_emptied_by_deletes():
    """Every edge of one of hub 0's replica rows deleted: the row stays
    in the group with no slots, and the merge is unchanged in kind."""
    g2, plan = _split(_skewed_edges(110, 3, 8), 110, 8, 8, 32)
    rows = ths.groups_of(plan)[0]
    r = rows[-1]
    prow = plan.primary_row
    nb = g2.nbr[r, :int(g2.deg[r])].tolist()
    edits = [(0, int(prow[x]), -1) for x in nb]
    g3, plan3 = ths.apply_mirrored_edits(g2, plan, edits)
    assert int(g3.deg[r]) == 0 and r in ths.groups_of(plan3)[0]
    rng = np.random.default_rng(3)
    for hi in (12, 3 * plan3.Km):
        _check(g3, plan3, torch.from_numpy(
            rng.integers(-2, hi, g3.N).astype(np.int32)))


def test_kernel_values_below_one_and_past_the_degree():
    """Fields of values below 1 only (h = 0), past every degree (h = the
    logical degree) and both mixed."""
    g2, plan = _split(_skewed_edges(110, 3, 12), 110, 8, 12, 32)
    rng = np.random.default_rng(4)
    big = 10 ** 6
    for f in (rng.integers(-50, 1, g2.N),
              rng.integers(big, 2 * big, g2.N),
              np.where(rng.random(g2.N) < 0.5, -7, big)):
        got, brute = _check(g2, plan, torch.from_numpy(f.astype(np.int32)))
    for h, rows in ths.groups_of(plan).items():
        assert brute[h] <= int(plan.ldeg[h])


def test_kernel_refuses_what_it_cannot_take():
    g2, plan = _split(_skewed_edges(110, 3, 8), 110, 8, 8, 32)
    gd, pd_ = _on(g2, plan, DEV)
    red = torch.zeros(g2.N, dtype=torch.int32, device=DEV)
    with pytest.raises(ValueError, match="pass deg"):
        hindex_mirror(red, red, gd.nbr, None, pd_)
    with pytest.raises(ValueError, match="field"):
        hindex_mirror(red, red.long(), gd.nbr, gd.deg, pd_)


def _edge_set(g2, plan):
    """The logical edges, as pairs of primary rows."""
    prow = plan.primary_row.numpy()
    nbr, deg = g2.nbr.numpy(), g2.deg.numpy()
    return {(min(int(prow[u]), int(prow[v])), max(int(prow[u]), int(prow[v])))
            for u in range(g2.N) for v in nbr[u, :deg[u]]}


def _windows(g2, plan, n_windows=4, width=6, seed=0):
    """Windows of inserts between primaries not yet joined and deletes of
    present edges, as primary-row ids."""
    rng = np.random.default_rng(seed)
    prim = np.flatnonzero(plan.primary_mask.numpy())
    cur = _edge_set(g2, plan)
    out = []
    for _ in range(n_windows):
        w = []
        while len(w) < width:
            if rng.random() < 0.5:
                u, v = map(int, rng.choice(prim, 2, replace=False))
                e = (min(u, v), max(u, v))
                if e not in cur:
                    cur.add(e)
                    w.append((u, v, +1))
            else:
                e = sorted(cur)[int(rng.integers(len(cur)))]
                cur.discard(e)
                w.append((e[0], e[1], -1))
        out.append(w)
    return out


def test_mirror_stream_on_the_card_launches_the_kernel():
    """A `MirrorStream` on the card refreshes coreness through the
    kernel, one launch a superstep; its coreness equals the same windows'
    on the CPU."""
    g2, plan = _split(_skewed_edges(110, 3, 8), 110, 8, 8, 64)
    windows = _windows(g2, plan)
    cpu = MirrorStream(g2, plan, backend="torch")
    for w in windows:
        cpu.apply_window(w)
    launches = hindex_mirror.launches
    gd, pd_ = _on(g2, plan, DEV)
    sess = MirrorStream(gd, pd_, backend="ell")
    assert hindex_mirror.launches - launches >= sess.refresh_steps > 0
    for w in windows:
        sess.apply_window(w)
    torch.cuda.synchronize()
    assert hindex_mirror.launches - launches >= sess.refresh_steps
    assert sess.refresh_steps == cpu.refresh_steps
    assert torch.equal(sess.core.cpu(), cpu.core)


@pytest.mark.parametrize("threshold", THRESHOLDS)
def test_fused_analytics_under_a_mirror_on_the_card(threshold):
    """The fused loop's h-index field merges through the kernel, its min
    and sum fields through the plan's group layout: coreness and labels equal
    the CPU's, ranks allclose."""
    g2, plan = _split(_skewed_edges(110, 3, threshold), 110, 8, threshold,
                      32)
    gd, pd_ = _on(g2, plan, DEV)
    launches = hindex_mirror.launches
    got = talg.fused_analytics(gd, steps=20, mirror=pd_)
    assert hindex_mirror.launches > launches
    want = talg.fused_analytics(g2, steps=20, mirror=plan)
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])
    torch.testing.assert_close(got[2].cpu(), want[2], rtol=1e-4, atol=1e-9)
    for backend in ("ell", "dense", "torch"):
        assert torch.equal(
            tcore.coreness(gd, backend=backend, mirror=pd_).cpu(),
            tcore.coreness(g2, backend="torch", mirror=plan))


@pytest.mark.parametrize("combine", ["min", "sum"])
def test_min_and_sum_merges_on_the_card_equal_the_cpu(combine):
    """The min and sum merges on the card read the same group layout as
    the h-index kernel and give the CPU's values, the float sums too (each
    group's partials added in the plan's order on both), with the same
    bits on a repeat run."""
    g2, plan = _split(_skewed_edges(110, 3, 12), 110, 8, 12, 32)
    gd, pd_ = _on(g2, plan, DEV)
    rng = np.random.default_rng(7)
    red = torch.from_numpy(rng.random(g2.N).astype(np.float32)
                           if combine == "sum" else
                           rng.integers(-3, 50, g2.N).astype(np.int32))
    want = ops._mirror_merge(red, red, g2.nbr, plan, combine)
    rd = red.to(DEV)
    got = ops._mirror_merge(rd, rd, gd.nbr, pd_, combine)
    assert torch.equal(got, ops._mirror_merge(rd, rd, gd.nbr, pd_, combine))
    assert torch.equal(got.cpu(), want)


# ---------------------------------------------------------------------------
# the coreness combine skips the group rows the merge rewrites
# ---------------------------------------------------------------------------

SKIP_STATES = ["split", "online_split", "emptied_replica", "grown",
               "hubs_off_row_0"]


def _split_window(g2, plan):
    """Inserts that push the unsplit primary of largest degree past the
    threshold, so that it splits on-line; primary-row ids."""
    prim = np.flatnonzero(plan.primary_mask.numpy())
    ldeg, gid = plan.ldeg.numpy(), plan.row_gid.numpy()
    u = max((int(r) for r in prim if gid[r] == plan.Gmax),
            key=lambda r: ldeg[r])
    cur = _edge_set(g2, plan)
    vs = [int(v) for v in prim
          if v != u and (min(u, v), max(u, v)) not in cur]
    return [(u, v, +1) for v in vs[:plan.threshold + 1 - int(ldeg[u])]]


def _emptying_window(g2, plan):
    """Deletes of every slot of the last replica row of a group whose last
    row has slots; returns (window, that row)."""
    hub, rows = next((h, r) for h, r in ths.groups_of(plan).items()
                     if len(r) >= 2 and int(g2.deg[r[-1]]))
    r, prow = rows[-1], plan.primary_row
    return [(hub, int(prow[x]), -1)
            for x in g2.nbr[r, :int(g2.deg[r])].tolist()], r


def _plan_in_state(state, threshold):
    """A skewed split graph on the CPU and its plan at `threshold`: as
    split, after an on-line split, after deletes that leave a replica with
    no slot, relocated by `grow_plan`, or with every hub out of block 0,
    so that row 0, the row `grp_rows` pads with, is in no group."""
    n = 110
    edges = _skewed_edges(n, 3, threshold)
    if state == "hubs_off_row_0":
        hub = np.bincount(edges.ravel(), minlength=n) > threshold
        assign = np.random.default_rng(0).integers(0, 8, n)
        g2, plan = ths.build_split_blocks(
            edges, n, np.where(hub, 1 + assign % 7, assign), 8, threshold,
            node_slack=32, device="cpu")
        assert int(plan.row_gid[0]) == plan.Gmax and int(g2.deg[0]) > 0
        return g2, plan
    g2, plan = _split(edges, n, 8, threshold, 32)
    if state == "online_split":
        window = _split_window(g2, plan)
        g3, plan3 = ths.apply_mirrored_edits(g2, plan, window)
        assert int(plan3.row_gid[window[0][0]]) < plan3.Gmax
        return g3, plan3
    if state == "emptied_replica":
        window, r = _emptying_window(g2, plan)
        g3, plan3 = ths.apply_mirrored_edits(g2, plan, window)
        assert int(g3.deg[r]) == 0 and int(plan3.row_gid[r]) < plan3.Gmax
        return g3, plan3
    if state == "grown":
        g3, rekey = grow_blocks(g2, Cn=2 * g2.Cn)
        return g3, ths.grow_plan(plan, rekey, g3)
    return g2, plan


def _skip_counts():
    return skip_group_rows.runs, int(skip_group_rows.rows)


@pytest.mark.parametrize("state", SKIP_STATES)
@pytest.mark.parametrize("threshold", THRESHOLDS)
def test_mirrored_coreness_skips_the_group_rows(threshold, state):
    """Where the ELL h-index kernel reads the row lengths, a mirrored
    coreness gives it 0 on the live group rows and equals the "torch"
    backend's coreness and step count; the merge kernel writes every row
    skipped, and the counters read one run and the plan's live group
    rows."""
    g2, plan = _plan_in_state(state, threshold)
    gd, pd_ = _on(g2, plan, DEV)
    runs, rows = _skip_counts()
    core, steps = tcore.coreness_with_stats(gd, backend="ell", mirror=pd_)
    live = pd_.row_gid < pd_.Gmax
    assert _skip_counts() == (runs + 1, rows + int(live.sum()))
    want, want_steps = tcore.coreness_with_stats(g2, backend="torch",
                                                 mirror=plan)
    assert torch.equal(core.cpu(), want) and steps == want_steps
    fill = torch.full((gd.N,), -1, dtype=torch.int32, device=DEV)
    assert torch.equal(hindex_mirror(fill, core, gd.nbr, gd.deg, pd_) >= 0,
                       live)


@pytest.mark.parametrize("threshold", [8, 16])
def test_mirror_stream_skipping_group_rows_equals_the_cpu(threshold):
    """A `MirrorStream` on "ell" on the card, over an on-line split,
    windows of inserts and deletes and a replica emptied, keeps the CPU
    "torch" session's core, labels and `refresh_steps` after every window;
    each refresh adds one run and the plan's live group rows to the skip
    counters, and the labels' min merge adds nothing."""
    g2, plan = _split(_skewed_edges(110, 3, threshold), 110, 8, threshold,
                      64)
    cpu = MirrorStream(g2, plan, backend="torch", cc_labels=True)
    gpu = MirrorStream(*_on(g2, plan, DEV), backend="ell", cc_labels=True)
    assert torch.equal(gpu.core.cpu(), cpu.core)
    windows = [_split_window(g2, plan)]
    for i in range(6):
        if i == 1:
            windows += _windows(cpu.g, cpu.mirror, seed=threshold)
        if i == 5:
            window, emptied = _emptying_window(cpu.g, cpu.mirror)
            windows.append(window)
        cpu.apply_window(windows[i])
        runs, rows = _skip_counts()
        gpu.apply_window(windows[i])
        live = int((gpu.mirror.row_gid < gpu.mirror.Gmax).sum())
        assert _skip_counts() == (runs + 1, rows + live), i
        assert torch.equal(gpu.core.cpu(), cpu.core), i
        assert torch.equal(gpu.labels.cpu(), cpu.labels), i
        assert gpu.refresh_steps == cpu.refresh_steps, i
    assert cpu.mirror.n_groups > plan.n_groups
    assert int(cpu.g.deg[emptied]) == 0
    assert int(cpu.mirror.row_gid[emptied]) < cpu.mirror.Gmax


@pytest.mark.parametrize("threshold", [8, 16])
def test_warm_mirror_stream_on_the_card_equals_the_cpu(threshold):
    """A `MirrorStream` on "ell" on the card warm-starts each window's
    refresh from the window's bound as the CPU "torch" session does: over
    an on-line split, windows of inserts and deletes, a grow and a
    replica emptied, the two keep the same core, `refresh_steps` and
    `warm_refreshes` window by window, the grow refreshes cold, and no
    warm refresh takes more supersteps than a cold coreness of its
    graph."""
    g2, plan = _split(_skewed_edges(110, 3, threshold), 110, 8, threshold,
                      64)
    cpu = MirrorStream(g2, plan, backend="torch")
    gpu = MirrorStream(*_on(g2, plan, DEV), backend="ell")
    assert gpu.refresh_steps == cpu.refresh_steps
    windows = [_split_window(g2, plan)]
    for i in range(6):
        if i == 1:
            windows += _windows(cpu.g, cpu.mirror, seed=threshold)
        if i == 3:
            warm = cpu.warm_refreshes
            cpu.grow(Cn=2 * cpu.g.Cn)
            gpu.grow(Cn=2 * gpu.g.Cn)
            assert gpu.warm_refreshes == cpu.warm_refreshes == warm
            assert gpu.refresh_steps == cpu.refresh_steps
        if i == 5:  # as open-time ids, which every window speaks
            window, _ = _emptying_window(cpu.g, cpu.mirror)
            opened = {int(r): o for o, r in enumerate(cpu._remap) if r >= 0}
            windows.append([(opened[u], opened[v], op)
                            for u, v, op in window])
        before = gpu.refresh_steps
        cpu.apply_window(windows[i])
        gpu.apply_window(windows[i])
        assert torch.equal(gpu.core.cpu(), cpu.core), i
        assert gpu.refresh_steps == cpu.refresh_steps, i
        assert gpu.warm_refreshes == cpu.warm_refreshes == i + 1, i
        _, cold = tcore.coreness_with_stats(gpu.g, backend="ell",
                                            mirror=gpu.mirror)
        assert gpu.refresh_steps - before <= cold, i
    want = tcore.coreness(cpu.g, backend="torch", mirror=cpu.mirror)
    assert torch.equal(cpu.core, want)
