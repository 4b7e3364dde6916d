"""PyTorch port vs the JAX package: hub mirroring.

The same numpy inputs — the JAX tests' split-worthy graphs (a
Barabási–Albert skew plus two planted hubs, random block cut) at split
thresholds 8, 12 and 16 — go through `repro.core.hub_split` and
`repro_torch.core.hub_split`:

* `split_hubs`, `apply_mirrored_edits` (on-line splits, mirrored
  deletes, and the reference's `ValueError`/`CapacityError` cases),
  `grow_plan` and `mirror_report` give the reference's graph and plan
  arrays and counters, element for element (plans field by field, all
  but `uid`);
* `_mirror_merge` gives the reference's merged values for min, sum and
  hindex, pad entries included (the sum allclose: its partials are
  added in another order);
* the mirrored runs (`run_block_program(mirror=)`: CC, PageRank,
  triangles, coreness, warm-started `fused_analytics`) on "torch",
  "ell" and "dense" (on the CPU "ell" and "dense" run the kernels' plain
  versions) equal the reference's mirrored run and, at primaries, the
  unsplit graph's: integers exactly, PageRank at RANK_TOL against the
  reference and atol=1e-5 against the unsplit graph (the reference's own
  bar);
* the ELL kernels get the split graph's row lengths `g.deg`, never the
  logical degrees `ldeg` (a spy on the wrappers); a mirrored coreness's
  h-index combine on "ell" gets them with 0 on exactly the rows the merge
  writes, on a plan as split, after an on-line split, after deletes that
  empty a replica and after `grow_plan`, and only that run moves the
  skip counters;
* `MirrorStream` windows (with an in-flight auto-grow and an explicit
  grow) keep the reference's graph, plan, core, labels and stats;
* the warm refresh: `kcore_dynamic.window_core_bound` lies between the
  final coreness and the degrees after random windows, on split graphs
  and their unsplit twins, and a planted window shows its band is
  needed; a warm `MirrorStream` equals a cold `coreness(mirror=)` after
  every window (deletes, inserts, the top core, an on-line split, an
  emptied replica, grows), in no more supersteps, and a restored one
  equals an uninterrupted one window by window.

The `cuda` tests hold the kernels against their plain versions on the
split rows and on the canonical rows, and the mirrored "ell" run on the
card against the plain run (`test_torch_mirror_hindex.py` holds the
coreness that skips the group rows on the card).
"""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (  # noqa: F401 (fixtures)
    assert_same_graph, needs_cuda, np_of, one_torch_thread, reference,
    require_cuda, to_port)

import repro.core as jcore
from repro.core import algorithms as jalg
from repro.core import hub_split as jhs
from repro.core.graph import grow_blocks as jgrow_blocks
from repro.graphgen import barabasi_albert
from repro.kernels import ops as jops

import repro_torch.core as tcore
from repro_torch.core import algorithms as talg
from repro_torch.core import hub_split as ths
from repro_torch.core import kcore_dynamic as kd
from repro_torch.core.graph import CapacityError, grow_blocks
from repro_torch.kernels import ops
from repro_torch.kernels.mirror_hindex import hindex_mirror, skip_group_rows
from repro_torch.runtime.stream import MirrorStream, StreamSession

pytestmark = pytest.mark.usefixtures("one_torch_thread")

BACKENDS = ["torch", "ell", "dense"]
THRESHOLDS = [8, 12, 16]
PR_STEPS = 12
RANK_TOL = dict(rtol=1e-4, atol=1e-9)
UNSPLIT_ATOL = 1e-5


def _skewed_edges(n, seed, threshold):
    """BA skew + two planted hubs (tests/test_hub_split.py's graph)."""
    edges = {(0, v) for v in range(1, 1 + threshold * 4)}
    edges |= {(1, v) for v in range(2 + threshold * 4, 2 + threshold * 5)}
    for u, v in barabasi_albert(n, 3, seed=seed):
        if u != v:
            edges.add((min(u, v), max(u, v)))
    return np.array(sorted(edges))


def _skewed_graph(n, seed, P=8, threshold=8, extra=0):
    edges = _skewed_edges(n, seed, threshold)
    assign = np.random.default_rng(seed).integers(0, P, n)
    g = jcore.build_blocks(edges, n, assign, P=P, node_slack=32 + extra)
    return g, edges, assign


@functools.lru_cache(maxsize=None)
def _split(threshold, seed=3, n=110):
    """(jg, jg2, jplan) of the reference: one split per threshold."""
    jg, _, _ = _skewed_graph(n, seed, threshold=threshold)
    jg2, jplan = jhs.split_hubs(jg, threshold=threshold)
    return jg, jg2, jplan


def _port_split(threshold):
    jg, _, _ = _split(threshold)
    return ths.split_hubs(to_port(jg), threshold)


def assert_same_plan(plan, jplan):
    """Field-by-field equality of two plans, all but `uid`."""
    for f in ths.MirrorPlan.ARRAYS:
        np.testing.assert_array_equal(np_of(getattr(plan, f)),
                                      np.asarray(getattr(jplan, f)),
                                      err_msg=f)
    for f in ("Gmax", "Km", "threshold", "n_logical"):
        assert getattr(plan, f) == getattr(jplan, f), f


def _bymap(oid, vals):
    return dict(zip(oid.tolist(), vals.tolist()))


# ---------------------------------------------------------------------------
# construction and accounting
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("threshold", THRESHOLDS)
def test_split_hubs_equals_reference(threshold):
    jg, jg2, jplan = _split(threshold)
    g2, plan = _port_split(threshold)
    assert_same_graph(g2, jg2)
    assert_same_plan(plan, jplan)
    assert g2.Cd == threshold < jg.Cd and plan.n_groups == jplan.n_groups
    assert ths.groups_of(plan) == jhs.groups_of(jplan)
    assert plan.primary_row.dtype == torch.int32
    assert plan.primary_mask.dtype == torch.bool


def test_split_hubs_errors_equal_reference():
    jg, _, _ = _skewed_graph(110, 3, threshold=8)
    with pytest.raises(ValueError, match="threshold must be >= 1"):
        ths.split_hubs(to_port(jg), 0)
    # no padding rows left for the replicas
    edges = _skewed_edges(60, 5, 8)
    tight = jcore.build_blocks(edges, 60, np.arange(60) % 2, P=2)
    with pytest.raises(CapacityError, match="no free padding rows"):
        ths.split_hubs(to_port(tight), 4)
    with pytest.raises(jcore.CapacityError, match="no free padding rows"):
        jhs.split_hubs(tight, 4)


@pytest.mark.parametrize("threshold", THRESHOLDS)
def test_mirror_report_equals_reference(threshold):
    jg, jg2, jplan = _split(threshold)
    g2, plan = _port_split(threshold)
    got = ths.mirror_report(to_port(jg), g2, plan)
    assert got == jhs.mirror_report(jg, jg2, jplan)
    assert got["merge_payload"] == plan.Gmax + 1
    assert got["alloc_ratio"] > 1 and got["slots_split"] == g2.N * g2.Cd


# ---------------------------------------------------------------------------
# the merge stage
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("threshold", THRESHOLDS)
@pytest.mark.parametrize("combine", ["min", "sum", "hindex"])
def test_mirror_merge_equals_reference(threshold, combine):
    _, jg2, jplan = _split(threshold)
    g2, plan = _port_split(threshold)
    gid = np.asarray(jplan.grp_gid)
    assert (gid == jplan.Gmax).any(), "the plan must carry pad entries"
    rng = np.random.default_rng(threshold)
    if combine == "sum":
        red = rng.random(g2.N).astype(np.float32)
    else:
        red = rng.integers(-3, 50, g2.N).astype(np.int32)
    field = rng.integers(-2, plan.Km + 6, g2.N).astype(np.int32)
    want = np.asarray(jops._mirror_merge(
        jnp.asarray(red), jnp.asarray(field), jg2.nbr, jplan, combine))
    got = ops._mirror_merge(torch.from_numpy(red), torch.from_numpy(field),
                            g2.nbr, plan, combine)
    assert got.dtype == torch.from_numpy(red).dtype
    if combine == "sum":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    else:
        np.testing.assert_array_equal(got.numpy(), want)
    # rows outside every group (row 0 is what pad entries point at) pass
    off = np.asarray(jplan.row_gid) == jplan.Gmax
    np.testing.assert_array_equal(got.numpy()[off], red[off])
    # the same bits on a second run
    again = ops._mirror_merge(torch.from_numpy(red), torch.from_numpy(field),
                              g2.nbr, plan, combine)
    assert torch.equal(got, again)


def test_mirror_merge_hindex_brute_force():
    """The histogram h-index of each group equals the h-index of the
    group's whole value multiset, for values past Km and below 1 too."""
    g2, plan = _port_split(8)
    rng = np.random.default_rng(4)
    field = torch.from_numpy(
        rng.integers(-3, 3 * plan.Km, g2.N).astype(np.int32))
    red = torch.zeros(g2.N, dtype=torch.int32)
    got = ops._mirror_merge(red, field, g2.nbr, plan, "hindex").numpy()
    nbr = g2.nbr.numpy()
    for h, rows in ths.groups_of(plan).items():
        vals = np.sort(np.concatenate(
            [field.numpy()[nbr[r][nbr[r] >= 0]] for r in rows]))[::-1]
        want = int(np.sum(vals >= np.arange(1, len(vals) + 1)))
        assert {int(got[r]) for r in rows} == {want}, h


@pytest.mark.parametrize("entry", ["connected_components", "pagerank"])
def test_mirrored_runs_read_nothing_of_the_plan_on_the_host(entry):
    """A mirrored CC and PageRank on the CPU read nothing of the plan on
    the host: their host reads are the live loop's, one a `SYNC_EVERY`
    supersteps and the superstep count, and their `bladyg.sync` spans
    those and the one around the logical node count, which the plan
    holds as a host int."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import tracing
    from repro_torch.analysis import entrypoints as E

    g2, plan = _port_split(12)
    run = {
        "connected_components": lambda: tcore.connected_components(
            g2, backend="torch", mirror=plan, with_steps=True),
        "pagerank": lambda: tcore.pagerank(
            g2, tol=None, max_steps=PR_STEPS, backend="torch", mirror=plan,
            with_steps=True),
    }[entry]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, steps = run()
    syncs = sum(e.name() == tracing.SYNC
                for e in prof.profiler.kineto_results.events())
    with E.count_host_reads("cpu") as box:
        run()
    assert box.count == -(-steps // ops.SYNC_EVERY) + 1
    assert syncs == box.count + 1


def _layout_plans(source):
    """The plans one way of making them gives: `split_hubs` at every
    threshold; `build_split_blocks` on the two-hub graph and the skewed
    one; `apply_mirrored_edits` over windows with two on-line splits;
    `grow_plan` after an edit window and again after the next one."""
    if source == "split_hubs":
        return [_port_split(t)[1] for t in THRESHOLDS]
    if source == "build_split_blocks":
        n = 1700
        assign = np.random.default_rng(0).integers(0, 4, n)
        plans = [ths.build_split_blocks(_two_hub_edges(n, 2, 1500, 12), n,
                                        assign, 4, t, node_slack=600,
                                        device="cpu")[1] for t in (4, 8)]
        _, edges, assign = _skewed_graph(110, 3, threshold=12)
        return plans + [ths.build_split_blocks(edges, 110, assign, 8, 12,
                                               node_slack=32,
                                               device="cpu")[1]]
    n = 100
    jg, edges, _ = _skewed_graph(n, 4, threshold=8, extra=64)
    g2, plan = ths.split_hubs(to_port(jg), 8)
    row_of = _row_of(*jhs.split_hubs(jg, 8))
    plans = []
    for i, w in enumerate(_edit_sequence(edges, n, row_of, 8, seed=8)):
        if i and source == "grow_plan":
            w = [(int(rekey[u]), int(rekey[v]), op) for u, v, op in w]
        g2, plan = ths.apply_mirrored_edits(g2, plan, w)
        if source == "grow_plan":
            g2, step = grow_blocks(g2, Cn=2 * g2.Cn)
            plan = ths.grow_plan(plan, step, g2)
            rekey = step if i == 0 else step[rekey]
        plans.append(plan)
    return plans


LAYOUT_SOURCES = ["split_hubs", "build_split_blocks",
                  "apply_mirrored_edits", "grow_plan"]


@pytest.mark.parametrize("source", LAYOUT_SOURCES)
def test_plans_list_each_group_whole_primary_first(source):
    """What the h-index kernel's offsets rest on: `grp_gid` is
    non-decreasing, its padding (gid Gmax) comes last, and each group's
    entries start at its primary and hold only its rows."""
    for plan in _layout_plans(source):
        gid = plan.grp_gid.numpy().astype(np.int64)
        rows = plan.grp_rows.numpy().astype(np.int64)
        prow = plan.primary_row.numpy().astype(np.int64)
        assert (np.diff(gid) >= 0).all()
        live = gid < plan.Gmax
        n_live = int(live.sum())
        assert live[:n_live].all() and gid[n_live:].tolist() == [
            plan.Gmax] * (len(gid) - n_live)
        starts = np.flatnonzero(np.r_[True, np.diff(gid[:n_live]) > 0])
        for a, b in zip(starts, np.r_[starts[1:], n_live]):
            head = rows[a]
            assert prow[head] == head, (a, head)
            assert (prow[rows[a:b]] == head).all()
        assert len(starts) == plan.n_groups


@pytest.mark.parametrize("source", LAYOUT_SOURCES)
def test_group_layout_equals_groups_of(source):
    """The offsets `group_layout` searches out on the device give the
    groups `groups_of` lists on the host, each primary first; `top` is
    each group's logical degree (0 on a pad group); `order` lists the
    groups by it, largest first and ties in group order, and `nbig`
    counts those above `WARP_TOP`."""
    from repro_torch.kernels.mirror_hindex import WARP_TOP, group_layout

    for plan in _layout_plans(source):
        lay = group_layout(plan)
        groups = ths.groups_of(plan)
        ldeg = plan.ldeg.tolist()
        off, top = lay.offsets.tolist(), lay.top.tolist()
        assert len(off) == plan.Gmax + 1 and off[0] == 0
        assert lay.top.dtype == torch.int64 and len(top) == plan.Gmax
        rows = plan.grp_rows.tolist()
        heads = []
        for g in range(plan.Gmax):
            mine = rows[off[g]:off[g + 1]]
            if not mine:
                assert top[g] == 0, g
                continue
            heads.append(mine[0])
            assert sorted(mine) == sorted(groups[mine[0]]), g
            assert top[g] == ldeg[mine[0]], g
        assert sorted(heads) == sorted(groups)
        order = lay.order.tolist()
        assert order == sorted(range(plan.Gmax), key=lambda g: -top[g])
        assert int(lay.nbig) == sum(ldeg[h] > WARP_TOP for h in groups)


def test_group_layout_reads_nothing_on_the_host():
    """`group_layout` runs on a plan of "meta" tensors, which hold no
    values: it makes no host read."""
    from repro_torch.kernels.mirror_hindex import group_layout

    _, plan = _port_split(8)
    meta = dataclasses.replace(plan, **{
        f: getattr(plan, f).to("meta") for f in ths.MirrorPlan.ARRAYS})
    lay = group_layout(meta)
    assert lay.offsets.shape == (plan.Gmax + 1,)
    assert lay.top.shape == lay.order.shape == (plan.Gmax,)
    assert lay.nbig.shape == ()


def test_hindex_mirror_on_the_cpu_is_the_plain_merge():
    """On CPU tensors the wrapper is the plain merge (with or without
    the plan's layout, and with `deg` unread); it refuses another device;
    the kernel's launch count does not move."""
    from repro_torch.kernels.mirror_hindex import group_layout, hindex_mirror

    g2, plan = _port_split(12)
    rng = np.random.default_rng(5)
    field = torch.from_numpy(
        rng.integers(-3, 2 * plan.Km, g2.N).astype(np.int32))
    red = torch.from_numpy(rng.integers(0, 9, g2.N).astype(np.int32))
    launches = hindex_mirror.launches
    want = ops._mirror_merge(red, field, g2.nbr, plan, "hindex")
    assert torch.equal(hindex_mirror(red, field, g2.nbr, None, plan), want)
    assert torch.equal(hindex_mirror(red, field, g2.nbr, g2.deg, plan,
                                     group_layout(plan)), want)
    assert hindex_mirror.launches == launches
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        hindex_mirror(red.to("meta"), field.to("meta"), g2.nbr.to("meta"),
                      None, plan)


# ---------------------------------------------------------------------------
# mirrored runs: equal to the reference's and to the unsplit graph's
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _reference_runs(threshold):
    """The reference's mirrored runs ("jnp") and the unsplit graph's, as
    host arrays."""
    jg, jg2, jplan = _split(threshold)
    core = np.asarray(jcore.coreness(jg2, backend="jnp", mirror=jplan))
    labels = np.asarray(jalg.connected_components(jg2, backend="jnp",
                                                  mirror=jplan))
    mirrored = dict(
        core=core, labels=labels,
        tri=np.asarray(jalg.triangle_counts(jg2, backend="jnp",
                                            mirror=jplan)),
        rank=np.asarray(jalg.pagerank(jg2, backend="jnp", tol=None,
                                      max_steps=PR_STEPS, mirror=jplan)),
        fused=tuple(np.asarray(x) for x in jalg.fused_analytics(
            jg2, steps=PR_STEPS, backend="jnp", init=(core, labels),
            mirror=jplan)))
    mask = np.asarray(jg.node_mask)
    oid = np.asarray(jg.orig_id)[mask]
    unsplit = dict(
        core=_bymap(oid, np.asarray(jcore.coreness(jg, backend="jnp"))[mask]),
        tri=_bymap(oid, np.asarray(jalg.triangle_counts(
            jg, backend="jnp"))[mask]),
        labels=_bymap(oid, np.asarray(jalg.connected_components(
            jg, backend="jnp"))[mask]),
        rank=_bymap(oid, np.asarray(jalg.pagerank(
            jg, backend="jnp", tol=None, max_steps=PR_STEPS))[mask]))
    return mirrored, unsplit


def _at_primaries(g2, plan, vals):
    pm = np_of(plan.primary_mask)
    return _bymap(np_of(g2.orig_id)[pm], np_of(vals)[pm])


def _assert_unsplit(g2, plan, got, unsplit):
    """Integers equal at primaries (labels hold unsplit padded ids, and
    every real row keeps its index); ranks within UNSPLIT_ATOL."""
    for k in ("core", "tri", "labels"):
        assert _at_primaries(g2, plan, got[k]) == unsplit[k], k
    rank = _at_primaries(g2, plan, got["rank"])
    keys = sorted(unsplit["rank"])
    np.testing.assert_allclose([rank[k] for k in keys],
                               [unsplit["rank"][k] for k in keys],
                               atol=UNSPLIT_ATOL)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("threshold", THRESHOLDS)
def test_mirrored_runs_equal_reference_and_unsplit(threshold, backend):
    mirrored, unsplit = _reference_runs(threshold)
    g2, plan = _port_split(threshold)
    core, steps = ops.run_block_program(
        g2, talg.CorenessBlockProgram(), backend=backend, mirror=plan,
        with_steps=True)
    got = dict(
        core=tcore.coreness(g2, backend=backend, mirror=plan),
        labels=tcore.connected_components(g2, backend=backend, mirror=plan),
        tri=tcore.triangle_counts(g2, backend=backend, mirror=plan),
        rank=tcore.pagerank(g2, backend=backend, tol=None,
                            max_steps=PR_STEPS, mirror=plan))
    assert torch.equal(torch.where(g2.node_mask, core, 0), got["core"])
    for k in ("core", "labels", "tri"):
        assert got[k].dtype == torch.int32
        np.testing.assert_array_equal(got[k].numpy(), mirrored[k], err_msg=k)
    np.testing.assert_allclose(got["rank"].numpy(), mirrored["rank"],
                               **RANK_TOL)
    _assert_unsplit(g2, plan, got, unsplit)
    # replicas carry their primary's values
    prow = plan.primary_row.long()
    for k in ("core", "labels", "tri", "rank"):
        assert torch.equal(got[k][g2.node_mask],
                           got[k][prow][g2.node_mask]), k
    # fused, warm-started from the maintained fields
    fc, fl, fr = tcore.fused_analytics(
        g2, steps=PR_STEPS, backend=backend, mirror=plan,
        init=(got["core"], got["labels"]))
    np.testing.assert_array_equal(fc.numpy(), mirrored["fused"][0])
    np.testing.assert_array_equal(fl.numpy(), mirrored["fused"][1])
    np.testing.assert_allclose(fr.numpy(), mirrored["fused"][2], **RANK_TOL)
    assert torch.equal(fc, got["core"]) and torch.equal(fl, got["labels"])
    np.testing.assert_allclose(fr.numpy(), got["rank"].numpy(), **RANK_TOL)


def test_mirrored_superstep_counts_equal_reference():
    _, jg2, jplan = _split(8)
    g2, plan = _port_split(8)
    for jprog, tprog in ((jalg.ConnectedComponentsProgram(),
                          talg.ConnectedComponentsProgram()),
                         (jalg.CorenessBlockProgram(),
                          talg.CorenessBlockProgram())):
        _, want = jops.run_block_program(jg2, jprog, backend="jnp",
                                         with_steps=True, mirror=jplan)
        _, got = ops.run_block_program(g2, tprog, backend="torch",
                                       with_steps=True, mirror=plan)
        assert got == int(want)
    _, n = ops.run_block_program(g2, talg.TriangleCountProgram(),
                                 with_steps=True, mirror=plan,
                                 backend="torch")
    assert n == 1


def test_kernels_get_row_lengths_not_logical_degrees(monkeypatch):
    """Under a mirror the update reads `ldeg` (up to the hub degree) and
    every ELL kernel `g.deg` (at most the threshold), the h-index
    combine's with the live group rows at 0 (the merge rewrites them): a
    kernel handed `ldeg` would read past its row.  Spies on the wrappers
    ops calls."""
    g2, plan = _port_split(8)
    assert not torch.equal(plan.ldeg, g2.deg)
    seen = []

    def spy(fn):
        def call(*args, deg=None, **kw):
            seen.append((fn.__name__, deg))
            return fn(*args, deg=deg, **kw)
        return call

    for name in ("neighbor_min_ell", "neighbor_sum_ell", "hindex_ell",
                 "neighbor_common_ell", "neighbor_multi_ell"):
        monkeypatch.setattr(ops, name, spy(getattr(ops, name)))
    tcore.coreness(g2, backend="ell", mirror=plan)
    tcore.connected_components(g2, backend="ell", mirror=plan)
    tcore.pagerank(g2, backend="ell", tol=None, max_steps=3, mirror=plan)
    tcore.triangle_counts(g2, backend="ell", mirror=plan)
    tcore.fused_analytics(g2, steps=3, backend="ell", mirror=plan)
    names = {n for n, _ in seen}
    assert names == {"neighbor_min_ell", "neighbor_sum_ell", "hindex_ell",
                     "neighbor_common_ell", "neighbor_multi_ell"}
    skipped = torch.where(plan.row_gid < plan.Gmax, 0, g2.deg)
    assert not torch.equal(skipped, g2.deg)
    for name, deg in seen:
        want = skipped if name == "hindex_ell" else g2.deg
        assert deg is not None and torch.equal(deg, want), name


SKIP_STATES = ["split", "online_split", "emptied_replica", "grown",
               "hubs_off_row_0"]


def _plan_in_state(state, threshold):
    """A hub-split graph and its plan at `threshold`: as split, after an
    on-line split (and a mirrored delete), after deletes that leave a
    replica with no slot, relocated by `grow_plan`, or split with no
    group row at row 0 (the row `grp_rows` pads with)."""
    if state == "hubs_off_row_0":
        n = 110
        edges = _skewed_edges(n, 3, threshold)
        hub = np.bincount(edges.ravel(), minlength=n) > threshold
        assign = np.random.default_rng(3).integers(0, 8, n)
        jg = jcore.build_blocks(edges, n, np.where(hub, 1 + assign % 7,
                                                   assign),
                                P=8, node_slack=32)
        g2, plan = ths.split_hubs(to_port(jg), threshold)
        assert int(plan.row_gid[0]) == plan.Gmax and int(g2.deg[0]) > 0
        assert bool((plan.grp_gid == plan.Gmax).any())
        return g2, plan
    if state == "online_split":
        n = 100
        jg, edges, _ = _skewed_graph(n, 5, threshold=threshold, extra=32)
        jg2, jplan = jhs.split_hubs(jg, threshold)
        g2, plan = ths.split_hubs(to_port(jg), threshold)
        edits, _, _ = _online_edits(edges, n, threshold, _row_of(jg2, jplan))
        g3, plan3 = ths.apply_mirrored_edits(g2, plan, edits)
        assert plan3.n_groups > plan.n_groups
        return g3, plan3
    g2, plan = _port_split(threshold)
    if state == "emptied_replica":
        hub, rows = next((h, r) for h, r in ths.groups_of(plan).items()
                         if len(r) >= 2)
        r, prow = rows[-1], plan.primary_row
        edits = [(hub, int(prow[x]), -1)
                 for x in g2.nbr[r, :int(g2.deg[r])].tolist()]
        g3, plan3 = ths.apply_mirrored_edits(g2, plan, edits)
        assert int(g3.deg[r]) == 0 and int(plan3.row_gid[r]) < plan3.Gmax
        return g3, plan3
    if state == "grown":
        g3, rekey = grow_blocks(g2, Cn=2 * g2.Cn)
        return g3, ths.grow_plan(plan, rekey, g3)
    return g2, plan


def _merge_writes(g, plan, field):
    """The rows the h-index merge writes, (N,) bool: it rewrites each
    group row from a fill no h takes."""
    fill = torch.full((g.N,), -1, dtype=torch.int32, device=g.device)
    return hindex_mirror(fill, field, g.nbr, g.deg, plan) >= 0


def _skip_counts():
    return skip_group_rows.runs, int(skip_group_rows.rows)


@pytest.mark.parametrize("state", SKIP_STATES)
@pytest.mark.parametrize("threshold", THRESHOLDS)
def test_hindex_combine_skips_exactly_the_rows_the_merge_writes(
        threshold, state, monkeypatch):
    """A mirrored coreness on "ell" gives its h-index combine `g.deg`
    with 0 on the live group rows (``row_gid < Gmax``), which are the rows
    the merge writes and those the plan's live entries list, and `g.deg`
    on every other row; one run, and those rows, in the skip counters.
    Coreness and steps equal the "torch" backend's."""
    g, plan = _plan_in_state(state, threshold)
    lens, orig = [], ops.hindex_ell

    def spy(nbr, est, K=None, deg=None, **kw):
        lens.append(deg)
        return orig(nbr, est, K=K, deg=deg, **kw)

    monkeypatch.setattr(ops, "hindex_ell", spy)
    runs, rows = _skip_counts()
    core, steps = tcore.coreness_with_stats(g, backend="ell", mirror=plan)
    live = plan.row_gid < plan.Gmax
    assert _skip_counts() == (runs + 1, rows + int(live.sum()))
    want, want_steps = tcore.coreness_with_stats(g, backend="torch",
                                                 mirror=plan)
    assert torch.equal(core, want) and steps == want_steps
    written = _merge_writes(g, plan, core)
    assert live.any() and torch.equal(written, live)
    entries = plan.grp_rows[plan.grp_gid < plan.Gmax].long()
    assert torch.equal(entries.sort().values, live.nonzero()[:, 0])
    assert len(lens) >= steps > 0 and all(d is lens[0] for d in lens)
    assert torch.equal(lens[0], torch.where(written, 0, g.deg))


@pytest.mark.parametrize("run", [
    "cc", "pagerank", "fused", "triangles", "unmirrored", "torch",
    "dense"])
def test_skip_counters_stay_zero_off_the_mirrored_ell_hindex(run):
    """Only a mirrored "hindex" combine on "ell" skips rows: mirrored min
    (CC), sum (PageRank), multi (fused) and count_common (triangles)
    programs, unmirrored runs and the other backends leave both counts
    as they were."""
    g2, plan = _port_split(8)
    g = to_port(_split(8)[0])
    before = _skip_counts()
    {
        "cc": lambda: tcore.connected_components(g2, backend="ell",
                                                 mirror=plan),
        "pagerank": lambda: tcore.pagerank(g2, backend="ell", tol=None,
                                           max_steps=3, mirror=plan),
        "fused": lambda: tcore.fused_analytics(g2, steps=3, backend="ell",
                                               mirror=plan),
        "triangles": lambda: tcore.triangle_counts(g2, backend="ell",
                                                   mirror=plan),
        "unmirrored": lambda: (
            tcore.coreness(g, backend="ell"),
            ops.run_block_program(g, talg.CorenessBlockProgram(),
                                  backend="ell")),
        "torch": lambda: tcore.coreness(g2, backend="torch", mirror=plan),
        "dense": lambda: tcore.coreness(g2, backend="dense", mirror=plan),
    }[run]()
    assert _skip_counts() == before


def test_run_block_program_still_refuses_executor():
    """`executor=` under a mirror: off the mesh it is not read, as in the
    JAX package (the run equals the reference's); on "ell_spmd" a
    long-lived executor of the split graph serves every mirrored
    workload, equal to the reference's mirrored runs."""
    from repro_torch.runtime.spmd import SpmdExecutor

    _, jg2, jplan = _split(8)
    g2, plan = _port_split(8)
    prog = talg.ConnectedComponentsProgram()
    want = np.asarray(jops.run_block_program(
        jg2, jalg.ConnectedComponentsProgram(), backend="jnp", mirror=jplan))
    np.testing.assert_array_equal(ops.run_block_program(
        g2, prog, executor=object(), mirror=plan).numpy(), want)
    ex = SpmdExecutor(g2)
    np.testing.assert_array_equal(ops.run_block_program(
        g2, prog, backend="ell_spmd", executor=ex, mirror=plan).numpy(),
        want)
    np.testing.assert_array_equal(
        tcore.coreness(g2, backend="ell_spmd", executor=ex,
                       mirror=plan).numpy(),
        np.asarray(jcore.coreness(jg2, backend="jnp", mirror=jplan)))
    assert ex.full_rebuilds == ex.plan_updates == 0


# ---------------------------------------------------------------------------
# on-line mutation
# ---------------------------------------------------------------------------


def _row_of(jg2, jplan):
    pm = np.asarray(jplan.primary_mask)
    return {int(o): i for i, o in enumerate(np.asarray(jg2.orig_id))
            if pm[i]}


def _online_edits(edges, n, threshold, row_of):
    """Inserts pushing a sub-threshold vertex over the threshold (an
    on-line split), then a mirrored delete of one of hub 0's edges; ids
    as primary rows.  Returns (edits, the edge set after them)."""
    cur = set(map(tuple, edges.tolist()))
    deg = np.zeros(n, np.int64)
    for u, v in cur:
        deg[u] += 1
        deg[v] += 1
    tgt = int(np.argmax(np.where(deg < threshold, deg, -1)))
    edits = []
    for v in np.argsort(deg)[::-1]:
        v = int(v)
        e = (min(tgt, v), max(tgt, v))
        if v != tgt and e not in cur:
            edits.append((tgt, v, +1))
            cur.add(e)
        if len(edits) == threshold + 4:
            break
    hub_e = next(e for e in sorted(cur) if e[0] == 0)
    edits.append((hub_e[0], hub_e[1], -1))
    cur.discard(hub_e)
    return [(row_of[u], row_of[v], op) for u, v, op in edits], cur, tgt


@pytest.mark.parametrize("threshold", THRESHOLDS)
def test_apply_mirrored_edits_equals_reference(threshold):
    n = 100
    jg, edges, assign = _skewed_graph(n, 5, threshold=threshold, extra=32)
    jg2, jplan = jhs.split_hubs(jg, threshold)
    g2, plan = ths.split_hubs(to_port(jg), threshold)
    row_of = _row_of(jg2, jplan)
    edits, cur, tgt = _online_edits(edges, n, threshold, row_of)
    before = {f: getattr(g2, f).clone() for f in ("nbr", "deg")}
    jg3, jplan3 = jhs.apply_mirrored_edits(jg2, jplan, edits)
    g3, plan3 = ths.apply_mirrored_edits(g2, plan, edits)
    assert_same_graph(g3, jg3)
    assert_same_plan(plan3, jplan3)
    assert plan3.n_groups > plan.n_groups, "the inserts must split tgt"
    assert len(ths.groups_of(plan3)[row_of[tgt]]) >= 2
    assert plan3.uid != plan.uid
    for f, t in before.items():  # the input graph is left as it was
        assert torch.equal(getattr(g2, f), t)
    assert g3.nbr.data_ptr() != g2.nbr.data_ptr()
    # exact against a graph built afresh from the edge set
    jfresh = jcore.build_blocks(np.array(sorted(cur)), n, assign, P=8)
    mask = np.asarray(jfresh.node_mask)
    oid = np.asarray(jfresh.orig_id)[mask]
    want = _bymap(oid, np.asarray(jcore.coreness(jfresh, backend="jnp"))[
        mask])
    got = tcore.coreness(g3, backend="torch", mirror=plan3)
    assert _at_primaries(g3, plan3, got) == want


def _raised(fn):
    try:
        fn()
    except (ValueError, CapacityError, jcore.CapacityError) as e:
        return type(e).__name__, str(e)
    return None


def _full_pool(threshold=4, n=60):
    """One block whose padding rows the split uses up: a vertex that then
    crosses the threshold finds no row for its replica."""
    edges = _skewed_edges(n, 5, threshold)
    deg = np.bincount(edges.ravel(), minlength=n)
    replicas = int(np.maximum(0, -(-deg // threshold) - 1).sum())
    jg = jcore.build_blocks(edges, n, np.zeros(n, np.int64), P=1,
                            Cn=n + replicas)
    jg2, jplan = jhs.split_hubs(jg, threshold)
    assert np.asarray(jg2.node_mask).all()
    row_of = _row_of(jg2, jplan)
    u = int(np.flatnonzero(deg == threshold)[0])
    nbrs = set(edges[(edges == u).any(1)].ravel().tolist())
    v = next(v for v in range(n) if v not in nbrs)
    return jg, jg2, jplan, [(row_of[u], row_of[v], +1)]


@pytest.mark.parametrize("case", [
    "present", "absent", "replica", "padding", "self_loop", "bad_op",
    "no_rows"])
def test_apply_mirrored_edits_errors_equal_reference(case):
    """The reference's error type and message, and the inputs unchanged
    (a failed window leaves no partial state)."""
    jg, jg2, jplan = _split(8)
    if case == "no_rows":
        jg, jg2, jplan, edits = _full_pool()
    else:
        row_of = _row_of(jg2, jplan)
        cur = set(map(tuple, np.asarray(jcore.to_networkx_edges(jg))
                      .tolist()))
        a, b = next((u, v) for u in range(2, 60) for v in range(u + 1, 60)
                    if (u, v) not in cur)
        hub, rows = next((h, r) for h, r in jhs.groups_of(jplan).items()
                         if len(r) >= 2)
        other = int(np.asarray(jplan.primary_row)[
            int(np.asarray(jg2.nbr)[hub, 0])])
        free = int(np.flatnonzero(~np.asarray(jg2.node_mask))[0])
        a, b = row_of[a], row_of[b]
        edits = {
            "present": [(hub, other, +1)],
            "absent": [(a, b, -1)],
            "replica": [(rows[1], a, +1)],
            "padding": [(free, a, +1)],
            "self_loop": [(a, a, +1)],
            "bad_op": [(a, b, 0)],
        }[case]
    g2, plan = ths.split_hubs(to_port(jg), jplan.threshold)
    before = {f: getattr(g2, f).clone() for f in ("nbr", "deg",
                                                  "node_mask")}
    want = _raised(lambda: jhs.apply_mirrored_edits(jg2, jplan, edits))
    assert want is not None
    got = _raised(lambda: ths.apply_mirrored_edits(g2, plan, edits))
    assert got == want
    for f, t in before.items():
        assert torch.equal(getattr(g2, f), t)


@pytest.mark.parametrize("threshold", [8, 12])
def test_grow_plan_equals_reference(threshold):
    _, jg2, jplan = _split(threshold)
    g2, plan = _port_split(threshold)
    jg3, jrekey = jgrow_blocks(jg2, Cn=2 * jg2.Cn)
    g3, rekey = grow_blocks(g2, Cn=2 * g2.Cn)
    np.testing.assert_array_equal(rekey, np.asarray(jrekey))
    jplan3 = jhs.grow_plan(jplan, np.asarray(jrekey), jg3)
    plan3 = ths.grow_plan(plan, rekey, g3)
    assert_same_plan(plan3, jplan3)
    assert plan3.uid != plan.uid
    assert plan3.ldeg.data_ptr() != plan.ldeg.data_ptr()
    # the relocated plan still gives the split == unsplit results
    core = tcore.coreness(g3, backend="torch", mirror=plan3)
    assert _at_primaries(g3, plan3, core) == _at_primaries(
        g2, plan, tcore.coreness(g2, backend="torch", mirror=plan))


# ---------------------------------------------------------------------------
# MirrorStream
# ---------------------------------------------------------------------------


def assert_same_mirror_stream(sess, jsess):
    assert_same_graph(sess.g, jsess.g)
    assert_same_plan(sess.mirror, jsess.mirror)
    np.testing.assert_array_equal(sess.core.numpy(), np.asarray(jsess.core))
    if jsess.labels is None:
        assert sess.labels is None
    else:
        np.testing.assert_array_equal(sess.labels.numpy(),
                                      np.asarray(jsess.labels))
    assert sess.windows_applied == jsess.windows_applied
    res, jres = sess.result(), jsess.result()
    assert tuple(res.stats) == tuple(jres.stats)
    assert len(res.stats) == 16


def _random_windows(edges, n, row_of, k=3, width=6, seed=1):
    """k windows of `width` random inserts/deletes (ids as primary rows)."""
    cur = set(map(tuple, edges.tolist()))
    rng = np.random.default_rng(seed)
    windows = []
    for _ in range(k):
        window, tried = [], set()
        while len(window) < width:
            u, v = (int(x) for x in rng.integers(0, n, 2))
            e = (min(u, v), max(u, v))
            if u == v or e in tried:
                continue
            tried.add(e)
            op = -1 if e in cur else +1
            (cur.discard if op < 0 else cur.add)(e)
            window.append((row_of[e[0]], row_of[e[1]], op))
        windows.append(window)
    return windows, cur


@pytest.mark.parametrize("threshold", [8, 16])
def test_mirror_stream_windows_equal_reference(threshold):
    n = 90
    jg, edges, assign = _skewed_graph(n, 2, threshold=threshold, extra=32)
    jg2, jplan = jhs.split_hubs(jg, threshold)
    g2, plan = ths.split_hubs(to_port(jg), threshold)
    jsess = reference().MirrorStream(jg2, jplan, backend="jnp",
                                     cc_labels=True)
    sess = MirrorStream(g2, plan, backend="torch", cc_labels=True)
    assert sess.mirror is plan and sess.executor is None
    assert_same_mirror_stream(sess, jsess)
    windows, cur = _random_windows(edges, n, _row_of(jg2, jplan))
    for i, w in enumerate(windows):
        if i == 1:  # an explicit grow: later windows stay open-time ids
            np.testing.assert_array_equal(sess.grow(Cn=2 * sess.g.Cn),
                                          np.asarray(jsess.grow(
                                              Cn=2 * jsess.g.Cn)))
        sess.apply_window(w)
        jsess.apply_window(w)
        assert_same_mirror_stream(sess, jsess)
    sess.apply_window([])
    assert sess.windows_applied == len(windows)
    res = sess.close()
    assert res.stats.grows == 1 and res.stats.updates == 6 * len(windows)
    # exact against the unsplit graph of the same edge set
    jfresh = jcore.build_blocks(np.array(sorted(cur)), n, assign, P=8)
    mask = np.asarray(jfresh.node_mask)
    oid = np.asarray(jfresh.orig_id)[mask]
    want = _bymap(oid, np.asarray(jcore.coreness(jfresh, backend="jnp"))[
        mask])
    assert _at_primaries(sess.g, sess.mirror, sess.core) == want


def _tiny_pool():
    """tests/test_growth.py's graph: node_slack=2, threshold 6."""
    n, threshold = 90, 6
    edges = {(0, v) for v in range(1, 1 + threshold * 3)}
    for u, v in barabasi_albert(n, 3, seed=4):
        if u != v:
            edges.add((min(u, v), max(u, v)))
    edges = np.array(sorted(edges))
    from repro.core.partition import node_random_partition
    assign = node_random_partition(n, 4, seed=5)
    jg = jcore.build_blocks(edges, n, assign, P=4, node_slack=2)
    return jg, edges, threshold


def test_mirror_stream_inflight_grow_equals_reference():
    jg, edges, threshold = _tiny_pool()
    jg2, jplan = jhs.split_hubs(jg, threshold)
    g2, plan = ths.split_hubs(to_port(jg), threshold)
    jsess = reference().MirrorStream(jg2, jplan, backend="jnp",
                                     cc_labels=True, auto_grow=True)
    sess = MirrorStream(g2, plan, backend="ell", cc_labels=True,
                        auto_grow=True)
    row_of = _row_of(jg2, jplan)
    tgt, cur, window = 2, set(map(tuple, edges.tolist())), []
    for v in range(90):
        e = (min(tgt, v), max(tgt, v))
        if tgt != v and e not in cur:
            cur.add(e)
            window.append((row_of[tgt], row_of[v], +1))
        if len(window) == 24:
            break
    # without auto-grow the window raises and changes nothing
    plain = MirrorStream(g2, plan, backend="torch", cc_labels=True)
    with pytest.raises(CapacityError):
        plain.apply_window(window)
    assert plain.g is g2 and plain.windows_applied == 0
    Cn0 = sess.g.Cn
    sess.apply_window(window)
    jsess.apply_window(window)
    assert sess._grows >= 1 and sess.g.Cn > Cn0
    assert_same_mirror_stream(sess, jsess)
    np.testing.assert_array_equal(
        sess.core.numpy(),
        tcore.coreness(sess.g, backend="torch", mirror=sess.mirror).numpy())


def test_stream_session_has_no_mirror():
    jg, _, _ = _split(8)
    g = to_port(jg)
    assert StreamSession(g, tcore.coreness(g), R=4).mirror is None


# ---------------------------------------------------------------------------
# MirrorStream's warm refresh: min-H from `window_core_bound`
# ---------------------------------------------------------------------------


def _port_split_graph(edges, n, threshold, slack=64, seed=0):
    assign = np.random.default_rng(seed).integers(0, 8, n)
    return ths.build_split_blocks(edges, n, assign, 8, threshold,
                                  node_slack=slack, device="cpu")


def _primary_rows(g2, plan):
    """{logical id: primary row}; edits and on-line splits keep them."""
    pm = np_of(plan.primary_mask)
    return {int(o): int(r) for r, o in enumerate(np_of(g2.orig_id))
            if pm[r]}


def _logical_edges(g2, plan):
    """The logical edges of a split graph, as sorted pairs of ids."""
    prow, oid = np_of(plan.primary_row), np_of(g2.orig_id)
    nbr, deg = np_of(g2.nbr), np_of(g2.deg)
    rows = np.repeat(np.arange(g2.N), deg)
    cols = nbr[np.arange(g2.Cd)[None, :] < deg[:, None]]
    a, b = oid[prow[rows]], oid[prow[cols]]
    return {(int(x), int(y)) for x, y in zip(np.minimum(a, b),
                                              np.maximum(a, b))}


def _edit_window(cur, core_of, rng, width, n):
    """`width` edits over logical ids, each pair once: deletes of present
    edges and inserts of absent pairs, half of the inserts between two of
    the highest cores, where a raised shell meets the next insert."""
    top = sorted(range(n), key=lambda x: -core_of[x])[:12]
    window, seen = [], set()
    while len(window) < width:
        if rng.random() < 0.4:
            e = sorted(cur)[int(rng.integers(len(cur)))]
        else:
            pool = top if rng.random() < 0.5 else range(n)
            u, v = (int(x) for x in rng.choice(pool, 2, replace=False))
            e = (min(u, v), max(u, v))
        if e in seen:
            continue
        seen.add(e)
        op = -1 if e in cur else +1
        (cur.discard if op < 0 else cur.add)(e)
        window.append((e[0], e[1], op))
    return window


def _unsplit_core(edges, n, assign):
    """(coreness, degrees, mask) of the unsplit graph, by logical id."""
    g = tcore.build_blocks(np.array(sorted(edges)), n, assign, P=8,
                           device="cpu")
    order = np.argsort(np_of(g.orig_id)[np_of(g.node_mask)])
    real = np.flatnonzero(np_of(g.node_mask))[order]
    pick = torch.from_numpy(real)
    return (tcore.coreness(g, backend="torch")[pick], g.deg[pick],
            g.node_mask[pick])


def _inserts(window):
    return [(u, v) for u, v, op in window if op > 0]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("twin", ["split", "unsplit"])
def test_window_core_bound_is_sound(twin, seed):
    """After random windows of 1-8 edits, the bound built from the exact
    coreness before a window lies between the coreness of the final graph
    and its degrees, and is 0 off the mask: on a split graph at its
    primary rows (logical degrees) and on its unsplit twin."""
    n, threshold = 110, 8
    edges = _skewed_edges(n, seed, threshold)
    assign = np.random.default_rng(seed).integers(0, 8, n)
    rng = np.random.default_rng(100 + seed)
    g2, plan = _port_split_graph(edges, n, threshold, seed=seed)
    row = _primary_rows(g2, plan)
    cur = set(map(tuple, edges.tolist()))
    raised = 0
    for _ in range(8):
        if twin == "split":
            core = tcore.coreness(g2, backend="torch", mirror=plan)
            core_of = {x: int(core[r]) for x, r in row.items()}
        else:
            core, _, _ = _unsplit_core(cur, n, assign)
            core_of = dict(enumerate(core.tolist()))
        window = _edit_window(cur, core_of, rng, int(rng.integers(1, 9)), n)
        if twin == "split":
            window = [(row[u], row[v], op) for u, v, op in window]
            g2, plan = ths.apply_mirrored_edits(g2, plan, window)
            deg, mask = plan.ldeg, plan.primary_mask
            want = tcore.coreness(g2, backend="torch", mirror=plan)
        else:
            want, deg, mask = _unsplit_core(cur, n, assign)
        bound = kd.window_core_bound(core, deg, mask, _inserts(window))
        assert bound.dtype == torch.int32
        assert bool((bound[mask] >= want[mask]).all())
        assert bool((bound[mask] <= deg[mask]).all())
        assert not bool(bound[~mask].any())
        raised += int((want[mask] > core[mask]).sum())
    assert raised > 0, "no window raised a coreness"


#: K5 less the edge (0, 1) is a 3-core; node 5 hangs off 1 and 2, and a
#: path 4-6-7-8 off it.  Insert (5, 3) raises 5 to the 3-shell; insert
#: (5, 0) then closes {0, .., 5} into a 4-core.  Both inserts see
#: K = min(2, 3) = 2, yet the second lifts the 3-shell: a bound that
#: counts only inserts with K equal to a node's coreness leaves it at 3.
BAND_EDGES = np.array([(0, 2), (0, 3), (0, 4), (1, 2), (1, 3), (1, 4),
                       (2, 3), (2, 4), (3, 4), (1, 5), (2, 5), (4, 6),
                       (6, 7), (7, 8)])
BAND_WINDOW = [(7, 8, -1), (5, 3, +1), (5, 0, +1)]


def _band0_bound(core, deg, mask, inserts):
    """`window_core_bound` with a band of 0: raised only by inserts whose
    K equals the node's coreness."""
    ends = torch.as_tensor(inserts)
    ks = torch.minimum(core[ends[:, 0]], core[ends[:, 1]])
    est = core + (core[:, None] == ks[None, :]).sum(1).to(core.dtype)
    return torch.where(mask, torch.minimum(est, deg), 0)


@pytest.mark.parametrize("twin", ["split", "unsplit"])
def test_window_core_bound_needs_the_band(twin):
    """Two inserts in one window, the second meeting the shell the first
    raised: a band of 0 undercuts the final coreness there, the bound's
    band of n - 1 does not, and the warm `MirrorStream` ends exact (the
    split graph at threshold 4, whose window splits node 3 on-line)."""
    n = 9
    assign = np.zeros(n, np.int64)
    final = {tuple(e) for e in BAND_EDGES.tolist()} - {(7, 8)}
    final |= {(3, 5), (0, 5)}
    if twin == "unsplit":
        core, _, _ = _unsplit_core(map(tuple, BAND_EDGES.tolist()), n,
                                   assign)
        want, deg, mask = _unsplit_core(final, n, assign)
        window = BAND_WINDOW
    else:
        g2, plan = _port_split_graph(BAND_EDGES, n, 4, slack=8)
        assert plan.n_groups == 2  # nodes 2 and 4
        row = _primary_rows(g2, plan)
        window = [(row[u], row[v], op) for u, v, op in BAND_WINDOW]
        sess = MirrorStream(g2, plan, backend="torch")
        core = sess.core
        sess.apply_window(window)
        assert sess.mirror.n_groups == 3  # node 3 split on-line
        deg, mask = sess.mirror.ldeg, sess.mirror.primary_mask
        want, cold = tcore.coreness_with_stats(sess.g, backend="torch",
                                               mirror=sess.mirror)
        assert torch.equal(sess.core, want) and sess.warm_refreshes == 1
    shell = mask & (core == 3)
    assert int(shell.sum()) == 5 and bool((want[shell] == 4).all())
    assert bool((_band0_bound(core, deg, mask, _inserts(window))[shell]
                 < 4).all())
    bound = kd.window_core_bound(core, deg, mask, _inserts(window))
    assert bool((bound[mask] >= want[mask]).all())


def _cold_core(sess):
    return tcore.coreness_with_stats(sess.g, backend="torch",
                                     mirror=sess.mirror)


def _top_core_window(sess, width=8):
    """`width` inserts between the rows of the highest cores not yet
    joined, the highest first; primary rows."""
    core = np_of(sess.core)
    prim = np.flatnonzero(np_of(sess.mirror.primary_mask))
    prim = prim[np.argsort(-core[prim], kind="stable")]
    oid = np_of(sess.g.orig_id)
    cur = _logical_edges(sess.g, sess.mirror)
    window = []
    for i, u in enumerate(prim):
        for v in prim[i + 1:]:
            e = tuple(sorted((int(oid[u]), int(oid[v]))))
            if e not in cur and len(window) < width:
                cur.add(e)
                window.append((int(u), int(v), +1))
    assert len(window) == width
    return window


def _warm_windows(case, sess, rng):
    """The windows (and grows, as None) of a warm-refresh case."""
    n = len(_primary_rows(sess.g, sess.mirror))
    row = _primary_rows(sess.g, sess.mirror)
    cur = _logical_edges(sess.g, sess.mirror)
    core_of = {x: int(sess.core[r]) for x, r in row.items()}

    def rows(w):
        return [(row[u], row[v], op) for u, v, op in w]

    if case == "deletes":
        es = sorted(cur)
        picks = rng.choice(len(es), 16, replace=False)
        return [rows([(*es[i], -1) for i in picks[:8]]),
                rows([(*es[i], -1) for i in picks[8:]])]
    if case == "inserts":
        out = []
        for _ in range(3):
            w = []
            while len(w) < 6:
                u, v = (int(x) for x in rng.choice(n, 2, replace=False))
                e = (min(u, v), max(u, v))
                if e not in cur:
                    cur.add(e)
                    w.append((e[0], e[1], +1))
            out.append(rows(w))
        return out
    if case == "top_core":
        return ["top"]
    if case == "split":
        prim = np.flatnonzero(np_of(sess.mirror.primary_mask))
        ldeg, gid = np_of(sess.mirror.ldeg), np_of(sess.mirror.row_gid)
        u = max((int(r) for r in prim if gid[r] == sess.mirror.Gmax),
                key=lambda r: ldeg[r])
        ou = int(sess.g.orig_id[u])
        vs = [x for x in range(n) if x != ou
              and (min(ou, x), max(ou, x)) not in cur]
        need = sess.mirror.threshold + 1 - int(ldeg[u])
        return [[(u, row[x], +1) for x in vs[:need]]]
    if case == "emptied":
        hub, rs = next((h, r) for h, r in ths.groups_of(sess.mirror).items()
                       if len(r) >= 2 and int(sess.g.deg[r[-1]]))
        prow, r = np_of(sess.mirror.primary_row), rs[-1]
        return [[(hub, int(prow[x]), -1)
                 for x in np_of(sess.g.nbr[r, :int(sess.g.deg[r])])]]
    assert case == "grow"
    ws = [rows(_edit_window(cur, core_of, rng, 8, n)) for _ in range(2)]
    return [ws[0], None, ws[1]]


WARM_CASES = ["deletes", "inserts", "top_core", "split", "emptied", "grow"]


@pytest.mark.parametrize("case", WARM_CASES)
def test_warm_mirror_stream_equals_cold_coreness(case):
    """After every window the warm session's coreness equals a cold
    `coreness(mirror=)` of its graph, each window's `refresh_steps`
    increment is at most the cold count, and `warm_refreshes` counts the
    windows alone: a `grow` refreshes cold, with the cold count, and the
    window after it is warm again."""
    n, threshold = 110, 8
    g2, plan = _port_split_graph(_skewed_edges(n, 3, threshold), n,
                                 threshold)
    sess = MirrorStream(g2, plan, backend="torch", cc_labels=True)
    _, open_steps = tcore.coreness_with_stats(g2, backend="torch",
                                              mirror=plan)
    assert sess.refresh_steps == open_steps and sess.warm_refreshes == 0
    saved = 0
    for w in _warm_windows(case, sess, np.random.default_rng(7)):
        before = sess.refresh_steps
        if w is None:
            sess.grow(Cn=2 * sess.g.Cn)
            want, cold = _cold_core(sess)
            assert sess.refresh_steps - before == cold
        else:
            w = _top_core_window(sess) if w == "top" else w
            warm = sess.warm_refreshes
            sess.apply_window(w)
            want, cold = _cold_core(sess)
            assert sess.warm_refreshes == warm + 1
            assert sess.refresh_steps - before <= cold
            saved += cold - (sess.refresh_steps - before)
        assert torch.equal(sess.core, want)
        assert torch.equal(sess.labels, talg.connected_components(
            sess.g, backend="torch", mirror=sess.mirror))
    assert sess.warm_refreshes == sess.windows_applied
    if case == "split":
        assert sess.mirror.n_groups == plan.n_groups + 1
    if case == "emptied":
        assert int(sess.g.deg.eq(0)[sess.mirror.row_gid < sess.mirror.Gmax]
                   .sum()) >= 1
    if case in ("deletes", "emptied"):
        assert saved > 0


def test_warm_refresh_survives_an_inflight_grow():
    """A window that runs the replica pool dry grows the graph in flight
    (a cold refresh on the grown rows), then re-applies and refreshes
    warm from that coreness: exact, one warm refresh."""
    jg, edges, threshold = _tiny_pool()
    jg2, jplan = jhs.split_hubs(jg, threshold)
    g2, plan = ths.split_hubs(to_port(jg), threshold)
    sess = MirrorStream(g2, plan, backend="torch", auto_grow=True)
    row_of = _row_of(jg2, jplan)
    cur, window = set(map(tuple, edges.tolist())), []
    for v in range(90):
        e = (min(2, v), max(2, v))
        if v != 2 and e not in cur:
            cur.add(e)
            window.append((row_of[2], row_of[v], +1))
        if len(window) == 24:
            break
    sess.apply_window(window)
    assert sess._grows >= 1 and sess.warm_refreshes == 1
    assert torch.equal(sess.core, _cold_core(sess)[0])


def test_window_core_bound_reads_nothing_and_cold_paths_refuse_it():
    """The bound is built on the device with no host read; a coreness
    without a mirror refuses a warm start."""
    from repro_torch.analysis.entrypoints import count_host_reads

    g2, plan = _port_split(8)
    core = tcore.coreness(g2, backend="torch", mirror=plan)
    with count_host_reads("cpu") as box:
        kd.window_core_bound(core, plan.ldeg, plan.primary_mask,
                             [(0, 1), (2, 3)])
    assert box.count == 0, box.sites
    with pytest.raises(ValueError, match="mirrored"):
        tcore.coreness_with_stats(g2, backend="torch", state0=core)


@pytest.mark.parametrize("threshold", [8, 12])
def test_restored_mirror_stream_equals_uninterrupted(threshold):
    """`from_state` mid-stream (after a grow, so the snapshot holds a
    remap): the restored session warm-starts its first window and equals
    the uninterrupted one window by window, in core and in each window's
    `refresh_steps` increment; its `warm_refreshes` counts from 0."""
    n = 110
    edges = _skewed_edges(n, 5, threshold)
    g2, plan = _port_split_graph(edges, n, threshold, seed=5)
    sess = MirrorStream(g2, plan, backend="torch")
    row, cur = _primary_rows(g2, plan), set(map(tuple, edges.tolist()))
    rng = np.random.default_rng(threshold)
    windows = []
    for _ in range(6):
        core_of = {x: int(sess.core[r]) for x, r in row.items()}
        windows.append([(row[u], row[v], op) for u, v, op in _edit_window(
            cur, core_of, rng, 8, n)])
    for w in windows[:3]:
        sess.apply_window(w)
        if sess.windows_applied == 1:
            sess.grow(Cn=2 * sess.g.Cn)
    arrays, meta = sess.state_dict()
    back = MirrorStream.from_state(arrays, meta, device="cpu")
    assert back.warm_refreshes == 0 and torch.equal(back.core, sess.core)
    for w in windows[3:]:
        steps = (sess.refresh_steps, back.refresh_steps)
        sess.apply_window(w)
        back.apply_window(w)
        assert torch.equal(back.core, sess.core)
        assert (back.refresh_steps - steps[1]
                == sess.refresh_steps - steps[0])
    assert back.warm_refreshes == 3 and sess.warm_refreshes == 6
    assert torch.equal(back.core, _cold_core(back)[0])


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@needs_cuda
@pytest.mark.parametrize("threshold", THRESHOLDS)
def test_kernels_on_split_rows_equal_plain(threshold):
    """Each ELL kernel against its plain version on the split graph's
    rows (serving-row ids, hub slices filling every slot) and on the
    canonical rows `run_common_mirror` gives the triangle kernel."""
    from repro_torch.core.graph import sort_nbr_rows
    from repro_torch.kernels.ell_cc import neighbor_min_ell
    from repro_torch.kernels.ell_hindex import hindex_ell, hindex_ell_plain
    from repro_torch.kernels.ell_multi import (
        neighbor_multi_ell, neighbor_multi_ell_plain)
    from repro_torch.kernels.ell_pagerank import neighbor_sum_ell
    from repro_torch.kernels.ell_triangles import neighbor_common_ell

    g2, plan = _port_split(threshold)
    dev = torch.device("cuda")
    nbr, deg = g2.nbr.to(dev), g2.deg.to(dev)
    prow = plan.primary_row.numpy().astype(np.int64)
    canon_np = g2.nbr.numpy().astype(np.int64)
    canon_np = sort_nbr_rows(np.where(canon_np >= 0,
                                      prow[np.maximum(canon_np, 0)], -1))
    canon = torch.from_numpy(canon_np.astype(np.int32)).to(dev)
    rng = np.random.default_rng(threshold)
    ints = torch.from_numpy(
        rng.integers(-2, 40, g2.N).astype(np.int32)).to(dev)
    floats = torch.from_numpy(rng.random(g2.N).astype(np.float32)).to(dev)
    for rows in (nbr, canon):
        assert torch.equal(hindex_ell(rows, ints, deg=deg),
                           hindex_ell_plain(rows.cpu(), ints.cpu()).to(dev))
        assert torch.equal(neighbor_min_ell(rows, ints, deg=deg).cpu(),
                           neighbor_min_ell(rows.cpu(), ints.cpu()))
        torch.testing.assert_close(
            neighbor_sum_ell(rows, floats, deg=deg).cpu(),
            neighbor_sum_ell(rows.cpu(), floats.cpu()), rtol=1e-5,
            atol=1e-9)
        assert torch.equal(neighbor_common_ell(rows, rows, deg=deg).cpu(),
                           neighbor_common_ell(rows.cpu(), rows.cpu()))
        fields = (ints, ints, floats)
        combines = ("hindex", "min", "sum")
        got = neighbor_multi_ell(rows, fields, combines, deg=deg)
        want = neighbor_multi_ell_plain(
            rows.cpu(), tuple(f.cpu() for f in fields), combines)
        assert torch.equal(got[0].cpu(), want[0])
        assert torch.equal(got[1].cpu(), want[1])
        torch.testing.assert_close(got[2].cpu(), want[2], rtol=1e-5,
                                   atol=1e-9)


@needs_cuda
@pytest.mark.parametrize("threshold", THRESHOLDS)
def test_mirrored_runs_on_gpu_equal_plain(threshold):
    g2, plan = _port_split(threshold)
    dev = torch.device("cuda")
    gd, pd_ = ths.split_hubs(to_port(_split(threshold)[0], dev), threshold)
    for f in ths.MirrorPlan.ARRAYS:
        assert torch.equal(getattr(pd_, f).cpu(), getattr(plan, f))
    for backend in ("ell", "dense"):
        assert torch.equal(
            tcore.coreness(gd, backend=backend, mirror=pd_).cpu(),
            tcore.coreness(g2, backend="torch", mirror=plan))
    for fn in (tcore.connected_components, tcore.triangle_counts):
        assert torch.equal(fn(gd, mirror=pd_).cpu(),
                           fn(g2, backend="torch", mirror=plan))
    torch.testing.assert_close(
        tcore.pagerank(gd, tol=None, max_steps=PR_STEPS, mirror=pd_).cpu(),
        tcore.pagerank(g2, backend="torch", tol=None, max_steps=PR_STEPS,
                       mirror=plan), **RANK_TOL)


# ---------------------------------------------------------------------------
# the split graph built from edges, the segmented h-index merge, the plan
# assembled in array code, and the mirrored stream's spans
# ---------------------------------------------------------------------------


def _two_hub_edges(n, seed, big, small):
    """A random sparse graph plus a hub of `big` neighbours and one of
    `small`: logical degrees that differ by far more than 100x."""
    rng = np.random.default_rng(seed)
    e = {tuple(sorted(map(int, p))) for p in rng.integers(0, n, (2 * n, 2))}
    e |= {(0, v) for v in rng.choice(np.arange(2, n), big, replace=False)}
    e |= {(1, v) for v in rng.choice(np.arange(2, n), small, replace=False)}
    return np.array(sorted((u, v) for u, v in e if u != v))


@pytest.mark.parametrize("threshold", THRESHOLDS + [3])
@pytest.mark.parametrize("seed", [3, 11])
def test_build_split_blocks_equals_split_hubs(threshold, seed):
    """Bit for bit the port's `split_hubs(build_blocks(...))` and the JAX
    package's `split_hubs`: graph arrays and every plan array."""
    n = 110
    jg, edges, assign = _skewed_graph(n, seed, threshold=threshold)
    jg2, jplan = jhs.split_hubs(jg, threshold)
    g2, plan = ths.build_split_blocks(edges, n, assign, 8, threshold,
                                      node_slack=32, device="cpu")
    assert_same_graph(g2, jg2)
    assert_same_plan(plan, jplan)
    from repro_torch.core.graph import build_blocks
    w2, wplan = ths.split_hubs(
        build_blocks(edges, n, assign, 8, node_slack=32, device="cpu"),
        threshold)
    for f in ("nbr", "deg", "node_mask", "orig_id"):
        assert torch.equal(getattr(g2, f), getattr(w2, f)), f
    for f in ths.MirrorPlan.ARRAYS:
        assert torch.equal(getattr(plan, f), getattr(wplan, f)), f
    # edges as a tensor, with loops and repeats, give the same
    noisy = np.r_[edges, edges[:7, ::-1], [[5, 5]]]
    g3, plan3 = ths.build_split_blocks(torch.from_numpy(noisy), n,
                                       torch.from_numpy(assign), 8,
                                       threshold, node_slack=32,
                                       device="cpu")
    assert torch.equal(g3.nbr, g2.nbr)
    assert torch.equal(plan3.grp_rows, plan.grp_rows)


@pytest.mark.parametrize("slack", [0, 4, 9, 17, 30])
def test_build_split_blocks_follows_the_allocation_fallback(slack):
    """Blocks of skewed sizes whose padding runs short: where a replica's
    reader block is full it goes to the hub's block, then to the lowest
    block with room, as `split_hubs` takes them one by one; where no row
    is left both raise `CapacityError`."""
    n, P, t = 120, 5, 3
    edges = _skewed_edges(n, 7, 6)
    assign = np.minimum(np.random.default_rng(1).geometric(0.4, n) - 1,
                        P - 1)
    jg = jcore.build_blocks(edges, n, assign, P=P, node_slack=slack)
    want = _raised(lambda: jhs.split_hubs(jg, t))
    got = _raised(lambda: ths.build_split_blocks(
        edges, n, assign, P, t, node_slack=slack, device="cpu"))
    assert (got is None) == (want is None)
    if want is not None:
        assert got[1] == want[1] and got[0] == "CapacityError"
        return
    jg2, jplan = jhs.split_hubs(jg, t)
    g2, plan = ths.build_split_blocks(edges, n, assign, P, t,
                                      node_slack=slack, device="cpu")
    assert_same_graph(g2, jg2)
    assert_same_plan(plan, jplan)


def test_build_split_blocks_refusals():
    edges = _skewed_edges(60, 5, 8)
    with pytest.raises(ValueError, match="threshold must be >= 1"):
        ths.build_split_blocks(edges, 60, np.zeros(60), 1, 0, device="cpu")
    with pytest.raises(ValueError, match="overflows node capacity"):
        ths.build_split_blocks(edges, 60, np.zeros(60), 1, 8, Cn=50,
                               device="cpu")
    with pytest.raises(ValueError, match="block ids"):
        ths.build_split_blocks(edges, 60, np.full(60, 3), 2, 8,
                               device="cpu")
    # padding runs out: the message split_hubs gives
    with pytest.raises(CapacityError, match="no free padding rows"):
        ths.build_split_blocks(edges, 60, np.arange(60) % 2, 2, 4,
                               device="cpu")


@pytest.mark.parametrize("threshold", [4, 8])
def test_segmented_hindex_merge_with_degrees_100x_apart(threshold):
    """Groups of logical degree 1,500 and 12 (and the BA skew's): the
    merge equals the JAX package's and the brute-force h-index of each
    group's values, for values past the degree, below 1 and padding."""
    from repro_torch.kernels.mirror_hindex import group_layout

    n = 1700
    edges = _two_hub_edges(n, 2, 1500, 12)
    assign = np.random.default_rng(0).integers(0, 4, n)
    jg = jcore.build_blocks(edges, n, assign, P=4, node_slack=600)
    jg2, jplan = jhs.split_hubs(jg, threshold)
    g2, plan = ths.build_split_blocks(edges, n, assign, 4, threshold,
                                      node_slack=600, device="cpu")
    lde = {h: int(plan.ldeg[h]) for h in ths.groups_of(plan)}
    assert max(lde.values()) >= 100 * min(lde.values())
    rng = np.random.default_rng(threshold)
    field = rng.integers(-3, 2 * 1500, g2.N).astype(np.int32)
    red = rng.integers(-3, 50, g2.N).astype(np.int32)
    got = ops._mirror_merge(torch.from_numpy(red), torch.from_numpy(field),
                            g2.nbr, plan, "hindex").numpy()
    want = np.asarray(jops._mirror_merge(
        jnp.asarray(red), jnp.asarray(field), jg2.nbr, jplan, "hindex"))
    np.testing.assert_array_equal(got, want)
    nbr = g2.nbr.numpy()
    for h, rows in ths.groups_of(plan).items():
        vals = np.sort(np.concatenate(
            [field[nbr[r][nbr[r] >= 0]] for r in rows]))[::-1]
        h_idx = int(np.sum(vals >= np.arange(1, len(vals) + 1)))
        assert {int(got[r]) for r in rows} == {h_idx}, h
    # the bins the merge counts in: one more than each group's degree,
    # within the histogram's length from shapes alone
    lay = group_layout(plan)
    off, top = lay.offsets.tolist(), lay.top.tolist()
    heads = plan.grp_rows[lay.offsets[:-1].clamp(max=plan.grp_rows.numel()
                                                 - 1)].tolist()
    assert top == [lde[h] if off[g] < off[g + 1] else 0
                   for g, h in enumerate(heads)]
    bins = sum(d + 1 for d in lde.values()) + (plan.Gmax - len(lde))
    assert sum(t + 1 for t in top) == bins
    assert bins <= plan.grp_rows.numel() * g2.Cd + plan.Gmax


def test_mirrored_runs_make_one_group_layout(monkeypatch):
    """Coreness, CC and PageRank under a mirror each make the plan's
    `group_layout` once a run, which every merge of the run reads, and
    equal the JAX package's mirrored runs."""
    from repro_torch.kernels import mirror_hindex

    g2, plan = _port_split(8)
    made = []
    orig = mirror_hindex.group_layout

    def spy(*a, **k):
        made.append(orig(*a, **k))
        return made[-1]

    monkeypatch.setattr(ops, "group_layout", spy)
    monkeypatch.setattr(mirror_hindex, "group_layout", spy)
    _, jg2, jplan = _split(8)
    core = tcore.coreness(g2, backend="torch", mirror=plan)
    assert len(made) == 1
    np.testing.assert_array_equal(
        core.numpy(), np.asarray(jcore.coreness(jg2, backend="jnp",
                                                mirror=jplan)))
    labels = tcore.connected_components(g2, backend="torch", mirror=plan)
    assert len(made) == 2
    np.testing.assert_array_equal(
        labels.numpy(), np.asarray(jalg.connected_components(
            jg2, backend="jnp", mirror=jplan)))
    rank = tcore.pagerank(g2, tol=None, max_steps=PR_STEPS, backend="torch",
                          mirror=plan)
    assert len(made) == 3
    np.testing.assert_allclose(
        rank.numpy(), np.asarray(jcore.pagerank(
            jg2, tol=None, max_steps=PR_STEPS, backend="jnp", mirror=jplan)),
        **RANK_TOL)


@pytest.mark.parametrize("threshold", THRESHOLDS)
def test_coreness_with_stats_mirror_equals_reference(threshold):
    """`coreness_with_stats(mirror=)` gives what `coreness(mirror=)` gives
    and the JAX package's mirrored coreness and superstep count."""
    _, jg2, jplan = _split(threshold)
    g2, plan = _port_split(threshold)
    core, steps = tcore.coreness_with_stats(g2, backend="torch",
                                            mirror=plan)
    _, want_steps = jops.run_block_program(
        jg2, jalg.CorenessBlockProgram(), backend="jnp", with_steps=True,
        mirror=jplan)
    np.testing.assert_array_equal(
        core.numpy(), np.asarray(jcore.coreness(jg2, backend="jnp",
                                                mirror=jplan)))
    assert steps == int(want_steps)
    assert torch.equal(core, tcore.coreness(g2, backend="torch",
                                            mirror=plan))


@pytest.mark.parametrize("extra", [0, 50])
def test_split_hubs_without_hubs_equals_reference(extra):
    """A threshold at or above the largest degree splits nothing: the
    reference's graph and a plan without groups."""
    jg, _, _ = _split(8)
    t = int(np.asarray(jg.deg).max()) + extra
    jg2, jplan = jhs.split_hubs(jg, t)
    g2, plan = ths.split_hubs(to_port(jg), t)
    assert_same_graph(g2, jg2)
    assert_same_plan(plan, jplan)
    assert plan.n_groups == 0


@pytest.mark.parametrize("shards", [2, 4])
def test_shard_merge_equals_whole(shards):
    """Each mesh shard's merge, over the plan seen from the shard, with an
    `all_reduce` that mins or sums across the shards, gives the
    single-device merge's rows for min, sum and the h-index.  The sums
    add whole numbers, so they are exact in any order."""
    from repro_torch.runtime import spmd

    g2, plan = _port_split(8)
    rng = np.random.default_rng(shards)
    red = {"min": torch.from_numpy(rng.integers(-3, 50, g2.N)
                                   .astype(np.int32)),
           "sum": torch.from_numpy(rng.integers(0, 50, g2.N)
                                   .astype(np.float32)),
           "hindex": torch.zeros(g2.N, dtype=torch.int32)}
    field = torch.from_numpy(rng.integers(-2, plan.Km + 6, g2.N)
                             .astype(np.int32))
    S = g2.N // shards
    views = [spmd._shard_plan(plan, lo, S, "cpu")
             for lo in range(0, g2.N, S)]
    assert len(views) == shards
    for combine, r in red.items():
        def merge(i, all_reduce):
            lo = i * S
            shard, layout, _ = views[i]
            return ops._mirror_merge(r[lo:lo + S], field,
                                     g2.nbr[lo:lo + S], shard, combine,
                                     all_reduce=all_reduce, layout=layout)

        parts = []
        for i in range(shards):  # each shard's partials, as sent
            merge(i, lambda x, op: parts.append((x.clone(), op)) or x)
        stack = torch.stack([x for x, _ in parts])
        op = parts[0][1]
        assert {o for _, o in parts} == {op}
        whole = stack.amin(0) if op == "min" else stack.sum(0)
        got = torch.cat([merge(i, lambda x, op: whole.clone())
                         for i in range(shards)])
        want = ops._mirror_merge(r, field, g2.nbr, plan, combine)
        assert torch.equal(got, want), combine


def _edit_sequence(edges, n, row_of, threshold, seed):
    """Windows of random edits, the first pushing two vertices over the
    threshold (two on-line splits in one call)."""
    cur = set(map(tuple, edges.tolist()))
    deg = np.bincount(edges.ravel(), minlength=n)
    rng = np.random.default_rng(seed)
    small = [int(u) for u in np.argsort(deg) if 0 < deg[u] < threshold][:2]
    first = []
    for tgt in small:
        for v in rng.permutation(n):
            e = (min(tgt, int(v)), max(tgt, int(v)))
            if tgt != v and e not in cur and len(
                    [x for x in first if tgt in x[:2]]) <= threshold:
                cur.add(e)
                first.append((tgt, int(v), +1))
    rest, _ = _random_windows(np.array(sorted(cur)), n,
                              {u: u for u in range(n)}, k=3, width=7,
                              seed=seed)
    return [[(row_of[u], row_of[v], op) for u, v, op in w]
            for w in [first] + rest]


@pytest.mark.parametrize("threshold", [8, 12])
def test_plan_assembly_equals_reference_over_edits_and_grows(threshold):
    """The array-built plans (`_plan_from_entries`, `group_arrays`) equal
    the JAX package's loops after each `apply_mirrored_edits` window and
    each `grow_plan`, groups split on-line included."""
    n = 100
    jg, edges, _ = _skewed_graph(n, 4, threshold=threshold, extra=64)
    jg2, jplan = jhs.split_hubs(jg, threshold)
    g2, plan = ths.split_hubs(to_port(jg), threshold)
    row_of = _row_of(jg2, jplan)
    windows = _edit_sequence(edges, n, row_of, threshold, seed=threshold)
    groups0 = plan.n_groups
    for i, w in enumerate(windows):
        jg2, jplan = jhs.apply_mirrored_edits(jg2, jplan, w)
        g2, plan = ths.apply_mirrored_edits(g2, plan, w)
        assert_same_graph(g2, jg2)
        assert_same_plan(plan, jplan)
        assert ths.groups_of(plan) == jhs.groups_of(jplan)
        if i == 1:
            jg2, jrekey = jgrow_blocks(jg2, Cn=2 * jg2.Cn)
            jplan = jhs.grow_plan(jplan, np.asarray(jrekey), jg2)
            g2, rekey = grow_blocks(g2, Cn=2 * g2.Cn)
            plan = ths.grow_plan(plan, rekey, g2)
            assert_same_plan(plan, jplan)
            row_of = {k: int(rekey[r]) for k, r in row_of.items()}
            windows[2:] = [[(int(rekey[u]), int(rekey[v]), op)
                            for u, v, op in w] for w in windows[2:]]
    assert plan.n_groups >= groups0 + 2
    heads, rows = ths.group_arrays(plan)
    assert (np.diff(heads) >= 0).all() and len(rows) == len(set(rows))


def _mirror_window_profiled(profiled):
    from torch.profiler import ProfilerActivity, profile

    g2, plan = _port_split(8)
    jg, _, _ = _split(8)
    sess = MirrorStream(g2, plan, backend="torch")
    steps0 = sess.refresh_steps
    cur = set(map(tuple, np.asarray(jcore.to_networkx_edges(jg)).tolist()))
    a, b = next((u, v) for u in range(2, 60) for v in range(u + 1, 60)
                if (u, v) not in cur)
    row_of = _row_of(*_split(8)[1:])
    window = [(row_of[a], row_of[b], +1)]
    if not profiled:
        sess.apply_window(window)
        return sess, steps0, []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sess.apply_window(window)
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.name().startswith("bladyg.")]
    return sess, steps0, names


def test_mirror_stream_window_spans_and_refresh_steps(monkeypatch):
    """Under the profiler one `MirrorStream` window is one
    `bladyg.mirror_window` holding one `bladyg.mirror_edits` and one
    `bladyg.mirror_refresh`, its host reads in `bladyg.sync`; with none
    running no span is recorded.  `refresh_steps` adds each refresh's
    supersteps, and the result is the same either way."""
    from repro_torch import tracing

    mirror = {tracing.MIRROR_WINDOW, tracing.MIRROR_EDITS,
              tracing.MIRROR_REFRESH}
    assert len(mirror) == 3 and all(n.startswith("bladyg.") for n in mirror)
    assert not mirror & {n for n, _ in tracing.SPANS}
    on, steps0, names = _mirror_window_profiled(True)
    counts = {x: names.count(x) for x in set(names)}
    assert counts[tracing.MIRROR_WINDOW] == 1
    assert counts[tracing.MIRROR_EDITS] == 1
    assert counts[tracing.MIRROR_REFRESH] == 1
    assert counts[tracing.SYNC] > 0
    assert steps0 > 0 and on.refresh_steps > steps0
    calls = []

    def spy(*args, **kwargs):
        calls.append(args)
        raise AssertionError("a record call with no profiler running")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", spy)
    off, steps0_off, _ = _mirror_window_profiled(False)
    assert calls == []
    assert torch.equal(on.core, off.core)
    assert on.refresh_steps == off.refresh_steps and steps0 == steps0_off
    want = tcore.coreness(off.g, backend="torch", mirror=off.mirror)
    assert torch.equal(off.core, want)


class _ReadSizes(torch.overrides.TorchFunctionMode):
    """Records the element count of every tensor copied to the host."""

    def __init__(self):
        super().__init__()
        self.sizes = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if getattr(func, "__name__", "") in ("cpu", "tolist") \
                and args and isinstance(args[0], torch.Tensor):
            self.sizes.append(args[0].numel())
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("threshold", [8, 12])
def test_apply_mirrored_edits_reads_only_the_rows_it_touches(threshold):
    """A window copies to the host the rows of its endpoints' groups and
    a few values each, never all of `nbr`; with an on-line split, the
    node mask once besides.  The result equals the JAX package's."""
    n = 100
    jg, edges, _ = _skewed_graph(n, 4, threshold=threshold, extra=64)
    jg2, jplan = jhs.split_hubs(jg, threshold)
    g2, plan = ths.split_hubs(to_port(jg), threshold)
    row_of = _row_of(jg2, jplan)
    first, second = _edit_sequence(edges, n, row_of, threshold,
                                   seed=threshold)[:2]
    made = []
    for window in (second, first):
        with _ReadSizes() as seen:
            g3, plan3 = ths.apply_mirrored_edits(g2, plan, window)
        rows = {r for u, v, _ in window for x in (u, v)
                for r in ths.groups_of(plan).get(x, [x])}
        splits = int(g3.node_mask.sum()) > int(g2.node_mask.sum())
        made.append(splits)
        big = [k for k in seen.sizes if k > len(rows) * g2.Cd]
        assert big == ([g2.N] if splits else []), (big, len(rows))
        jg3, jplan3 = jhs.apply_mirrored_edits(jg2, jplan, window)
        assert_same_graph(g3, jg3)
        assert_same_plan(plan3, jplan3)
    assert made[1], "the first window splits two vertices on-line"
