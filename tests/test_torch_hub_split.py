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
  logical degrees `ldeg` (a spy on the wrappers);
* `MirrorStream` windows (with an in-flight auto-grow and an explicit
  grow) keep the reference's graph, plan, core, labels and stats.

The `cuda` tests hold the kernels against their plain versions on the
split rows and on the canonical rows, and the mirrored "ell" run on the
card against the plain run.
"""
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
from repro_torch.core.graph import CapacityError, grow_blocks
from repro_torch.kernels import ops
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


def test_merge_index_layout():
    g2, plan = _port_split(12)
    idx = ops.merge_index(plan, g2.N)
    groups = ths.groups_of(plan)
    assert idx.table.shape[0] == plan.Gmax
    for gx, (h, rows) in enumerate(sorted(groups.items())):
        row = idx.table[gx].tolist()
        assert row[:len(rows)] == rows and set(row[len(rows):]) <= {g2.N}
    assert sorted(idx.rows.tolist()) == sorted(r for rs in groups.values()
                                               for r in rs)


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
    every ELL kernel `g.deg` (at most the threshold): a kernel handed
    `ldeg` would read past its row.  Spies on the wrappers ops calls."""
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
    for name, deg in seen:
        assert deg is not None and torch.equal(deg, g2.deg), name


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
