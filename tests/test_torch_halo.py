"""PyTorch port vs the JAX package: the mesh runtime's halo plan.

`repro_torch.runtime.halo.build_halo_plan` against
`repro.runtime.halo.build_halo_plan` on the same graph and mesh geometry:
every scalar and every array of the plan must be EQUAL, at W in
{1, 2, 4, 8} (the fold B = P / W from 8 down to 1), with and without
`H_min`/`K_min` floors, and after `HaloPlan.apply_updates` over random
insert/delete windows (the port of `tests/test_halo_incremental.py`:
the maintained plan equals a fresh build with the same floors, in both
packages, including the capacity-doubling path).  The plans are built
in one process: both packages' plans are host numpy of `nbr`, so a
`WorkerMesh` with no process group (the port) or no jax mesh (the JAX
package) carries the geometry at any W.
"""
import numpy as np
import pytest

from _hyp import given, settings, st
from _torch_port import (  # noqa: F401 (fixtures)
    one_torch_thread, reference, to_port)

import repro.core as jcore
import repro.core.partition as jpart
import repro.core.updates as jupd
import repro.graphgen as jgen

import repro_torch.core as tcore
import repro_torch.core.updates as tupd
from repro_torch.runtime import halo as thalo
from repro_torch.runtime import mesh as tmesh

pytestmark = pytest.mark.usefixtures("one_torch_thread")

reference()  # the JAX runtime package, imported with its warning ignored
import repro.runtime.halo as jhalo  # noqa: E402
import repro.runtime.mesh as jmesh  # noqa: E402

SCALAR_FIELDS = ("K", "H", "slot_intra", "slot_inter", "device_elems",
                 "padded_elems", "pad_slot")
ARRAY_FIELDS = ("send_idx", "recv_pos", "halo_len", "halo_ids",
                "nbr_local", "pair_elems")


def _meshes(g, W):
    """The port's and the JAX package's mesh geometry at W (no group, no
    devices: the plan needs only the fold)."""
    t = tmesh.WorkerMesh(group=None, W=W, P=g.P, B=g.P // W, Cn=g.Cn)
    j = jmesh.WorkerMesh(mesh=None, W=W, P=g.P, B=g.P // W, Cn=g.Cn)
    return t, j


def assert_same_plan(t, j, ctx=""):
    for f in SCALAR_FIELDS:
        assert getattr(t, f) == getattr(j, f), (ctx, f)
    assert t.slot_counts() == j.slot_counts(), ctx
    for f in ARRAY_FIELDS:
        a, b = getattr(t, f), getattr(j, f)
        assert a.dtype == b.dtype, (ctx, f)
        np.testing.assert_array_equal(a, b, err_msg=f"{ctx} {f}")


def _graph(P, seed, n=None):
    edges = jgen.barabasi_albert(n or 100 + 10 * P, 3, seed=seed)
    nn = int(edges.max()) + 1
    assign = jpart.node_random_partition(nn, P, seed=seed + 1)
    return jcore.build_blocks(edges, nn, assign, P=P, deg_slack=48)


def _stream(jg, seed, windows=4, per=4):
    """`windows` windows of mixed valid insert/delete updates, each valid
    on the graph after the ones before it."""
    out = []
    for w in range(windows):
        s = seed * 1000 + w
        ups = (jupd.sample_insertions(jg, 2, "inter", seed=s)
               + jupd.sample_insertions(jg, 1, "intra", seed=s + 500)
               + jupd.sample_deletions(jg, 2, "inter", seed=s)
               + jupd.sample_deletions(jg, 1, "intra", seed=s + 500))
        out.append(ups[:per])
        jg = jupd.apply_updates_host(jg, ups[:per])
    return out


def test_pow2_ceil_policy():
    assert [thalo._pow2_ceil(x) for x in (0, 1, 2, 3, 4, 5, 8, 9)] == \
        [jhalo._pow2_ceil(x) for x in (0, 1, 2, 3, 4, 5, 8, 9)] == \
        [1, 1, 2, 4, 4, 8, 8, 16]


@pytest.mark.parametrize("W", (1, 2, 4, 8))
def test_plan_equals_reference(W):
    jg = _graph(8, seed=3)
    tg = to_port(jg)
    tw, jw = _meshes(jg, W)
    assert (tw.S, tw.N, tw.worker_of(jg.N - 1)) == \
        (jw.S, jw.N, jw.worker_of(jg.N - 1))
    plan = thalo.build_halo_plan(tg, tw)
    assert_same_plan(plan, jhalo.build_halo_plan(jg, jw), ctx=W)
    assert plan.slot_counts() == tcore.halo_slot_counts(tg)
    # with capacity floors above the natural sizes
    floors = dict(H_min=2 * plan.H + 3, K_min=plan.K + 1)
    assert_same_plan(thalo.build_halo_plan(tg, tw, **floors),
                     jhalo.build_halo_plan(jg, jw, **floors), ctx=(W, "floor"))


@pytest.mark.parametrize("W", (1, 2, 4, 8))
def test_incremental_plan_equals_reference(W):
    """apply_updates over 5 random windows: the port's maintained plan
    equals the JAX package's maintained plan and a fresh build with the
    same floors, window by window."""
    jg = _graph(8, seed=5)
    tg = to_port(jg)
    tw, jw = _meshes(jg, W)
    tp, jp = thalo.build_halo_plan(tg, tw), jhalo.build_halo_plan(jg, jw)
    for i, window in enumerate(_stream(jg, seed=7, windows=5)):
        jg = jupd.apply_updates_host(jg, window)
        tg = tupd.apply_updates_host(tg, window)
        tp2, jp2 = tp.apply_updates(tg, window), jp.apply_updates(jg, window)
        assert_same_plan(tp2, jp2, ctx=(W, i))
        assert_same_plan(
            tp2, thalo.build_halo_plan(tg, tw, H_min=tp.H, K_min=tp.K),
            ctx=(W, i, "fresh"))
        tp, jp = tp2, jp2


@settings(max_examples=8, deadline=None)
@given(st.integers(min_value=0, max_value=10_000))
def test_incremental_plan_hypothesis(seed):
    """Property form: any sampled stream, P in {2, 4, 8}, every W | P."""
    P = (2, 4, 8)[seed % 3]
    jg = _graph(P, seed=seed % 50)
    tg = to_port(jg)
    W = (1, 2, P)[(seed // 3) % 3]
    tw, jw = _meshes(jg, W)
    tp, jp = thalo.build_halo_plan(tg, tw), jhalo.build_halo_plan(jg, jw)
    for window in _stream(jg, seed=seed, windows=3):
        jg = jupd.apply_updates_host(jg, window)
        tg = tupd.apply_updates_host(tg, window)
        tp, jp = tp.apply_updates(tg, window), jp.apply_updates(jg, window)
        assert_same_plan(tp, jp, ctx=(seed, P, W))


@pytest.mark.parametrize("W", (1, 2))
def test_capacity_growth_path(W):
    """Flooding cross-block edges overflows H and K; the doubling policy
    lands the maintained plan on the fresh build and on the JAX
    package's maintained plan."""
    n = 16
    edges = ([(i, i + 1) for i in range(7)]
             + [(8 + i, 9 + i) for i in range(7)] + [(0, 8)])
    assign = np.array([0] * 8 + [1] * 8)
    jg = jcore.build_blocks(np.array(edges), n, assign, P=2, Cd=14)
    tg = to_port(jg)
    tw, jw = _meshes(jg, W)
    tp, jp = thalo.build_halo_plan(tg, tw), jhalo.build_halo_plan(jg, jw)
    H0 = tp.H
    orig = np.asarray(jg.orig_id)
    pad_of = {int(orig[i]): i for i in range(jg.N) if orig[i] >= 0}
    nbr = np.asarray(jg.nbr)
    ups = [(pad_of[a], pad_of[b], +1)
           for a in range(8) for b in range(8, 16)
           if not (nbr[pad_of[a]] == pad_of[b]).any()]
    grew = False
    for i in range(0, len(ups), 3):
        window = ups[i:i + 3]
        try:
            jg2 = jupd.apply_updates_host(jg, window)
        except ValueError:  # degree capacity reached; enough flooding
            break
        tg = tupd.apply_updates_host(tg, window)
        tp2, jp2 = tp.apply_updates(tg, window), jp.apply_updates(jg2, window)
        assert_same_plan(tp2, jp2, ctx=i)
        assert_same_plan(
            tp2, thalo.build_halo_plan(tg, tw, H_min=tp.H, K_min=tp.K),
            ctx=(i, "fresh"))
        grew = grew or tp2.H > tp.H or tp2.K > tp.K
        jg, tp, jp = jg2, tp2, jp2
    if W > 1:  # W = 1 has no halo at all; growth needs real workers
        assert grew and tp.H > H0


def test_apply_updates_skips_padding_ops_and_empty():
    jg = _graph(2, seed=5)
    tg = to_port(jg)
    tw, _ = _meshes(jg, 2)
    plan = thalo.build_halo_plan(tg, tw)
    assert plan.apply_updates(tg, []) is plan
    u, v, _ = jupd.sample_insertions(jg, 1, "inter", seed=0)[0]
    noop = plan.apply_updates(tg, [(u, v, 0)])
    for f in ARRAY_FIELDS:
        np.testing.assert_array_equal(getattr(noop, f), getattr(plan, f))


def test_make_worker_mesh_defaults_to_one_worker():
    tg = to_port(_graph(4, seed=1))
    wm = tmesh.make_worker_mesh(tg)
    assert (wm.group, wm.W, wm.B, wm.S, wm.rank) == (None, 1, 4, tg.N, 0)
    assert wm.device == tg.device
    plan = thalo.build_halo_plan(tg)  # the mesh comes from the graph
    assert (plan.wm, plan.H, plan.K) == (wm, 1, 1)
    assert (plan.halo_len == 0).all() and plan.device_elems == 0
    np.testing.assert_array_equal(
        np.where(plan.nbr_local == plan.pad_slot, -1, plan.nbr_local),
        tg.nbr.numpy())


def test_mirror_merge_payload_lives_in_halo():
    """The counter moved to `runtime.halo`, as in the JAX package; the
    mirror report still reads it."""
    import repro.core.hub_split as jhub
    import repro_torch.core.hub_split as thub

    edges = jgen.barabasi_albert(120, 3, seed=2)
    n = int(edges.max()) + 1
    jg = jcore.build_blocks(edges, n, np.arange(n) % 2, P=2, deg_slack=4,
                            node_slack=24)
    jg2, jplan = jhub.split_hubs(jg, 8)
    tg2, tplan = thub.split_hubs(to_port(jg), 8)
    assert not hasattr(thub, "mirror_merge_payload")
    assert thalo.mirror_merge_payload(tplan, 3) == \
        jhalo.mirror_merge_payload(jplan, 3) == (jplan.Gmax + 1) * 3
    assert thub.mirror_report(to_port(jg), tg2, tplan)["merge_payload"] == \
        jhub.mirror_report(jg, jg2, jplan)["merge_payload"]
