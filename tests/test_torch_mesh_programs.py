"""PyTorch port vs the JAX package: the mesh runtime's programs and the
mesh paths of maintenance, the stream and restore, on W = 2, 4 and 8
workers (spawned gloo ranks on the CPU) and at W = 1 in this process.

Every rank runs `_torch_mesh_worker.run_programs` on a P = 8 graph (so
W = 2 folds four blocks onto each worker) and must return the JAX
package's single-device "jnp" results, which the JAX package asserts
every W gives: CC labels, triangle counts, `fused_analytics`' coreness
and labels, `coreness_via_spmd`, mirrored coreness, CC and triangles on a
hub-split graph, `maintain_batch`'s graph, coreness and stats, and a
windowed `StreamSession` and its restored snapshot (graph, coreness,
labels, every `StreamStats` field) bit for bit, with equal superstep
counts; PageRank (also mirrored, and fused) to ``atol=2e-6``.  The halo
plan counters of the stream (`plan_updates`, `plan_rebuilds`), which the
single-device reference does not keep, equal the W = 1 mesh run's.  Each
gloo job has the time limits of `_torch_mesh_worker` (60 s a collective,
240 s the job); one spawn per W carries every case.

Run alone: ``PYTHONPATH=src python -m pytest -q
tests/test_torch_mesh_programs.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_port import (  # noqa: F401 (fixtures)
    FLOAT_ATOL, np_of, one_torch_thread, reference, to_port)
import _torch_mesh_worker as mesh_worker

import repro.core as jcore
import repro.core.partition as jpart
import repro.core.updates as jupd
import repro.graphgen as jgen
from repro.core import hub_split as jhs

pytestmark = pytest.mark.usefixtures("one_torch_thread")

P = 8
PR_STEPS = 10
THRESHOLD = 12
RESTORE_AT = 2  # windows before the snapshot the stream restores

#: results compared with a float tolerance; all others bit for bit
FLOATS = ("pr", "pr30", "fused_rank", "m_pr")


def _jclone(jg):
    return jax.tree.map(lambda x: jnp.copy(x) if hasattr(x, "dtype") else x,
                        jg)


def _graphs():
    edges = jgen.barabasi_albert(150, 4, seed=11)
    n = int(edges.max()) + 1
    jg = jcore.build_blocks(edges, n, jpart.node_random_partition(
        n, P, seed=2), P=P, deg_slack=24)
    edges = jgen.barabasi_albert(120, 4, seed=13)
    n = int(edges.max()) + 1
    js = jcore.build_blocks(edges, n, jpart.node_random_partition(
        n, P, seed=3), P=P, node_slack=24)
    return jg, js


def _want(jg, js, ups):
    """The JAX package's single-device "jnp" results."""
    want = {}
    for name, (val, steps) in {
            "cc": jcore.connected_components(jg, backend="jnp",
                                             with_steps=True),
            "pr": jcore.pagerank(jg, backend="jnp", with_steps=True),
            "pr30": jcore.pagerank(jg, tol=None, max_steps=30,
                                   backend="jnp", with_steps=True),
            "tri": jcore.triangle_counts(jg, backend="jnp",
                                         with_steps=True)}.items():
        want[name], want[name + "_steps"] = np_of(val), int(steps)
    (fc, fl, fr), n = jcore.fused_analytics(jg, steps=PR_STEPS,
                                            backend="jnp", with_steps=True)
    want.update(fused_core=np_of(fc), fused_labels=np_of(fl),
                fused_rank=np_of(fr), fused_steps=int(n))
    core, eng = jcore.coreness_via_engine(jg)
    want["via_spmd"], want["via_spmd_traces"] = np_of(core), len(eng.traces)
    _, jeng = jcore.coreness_via_spmd(jg, W=1)
    want["via_spmd_totals"] = np.asarray(tuple(jeng.message_totals()))
    jg2, jplan = jhs.split_hubs(js, threshold=THRESHOLD)
    want["m_core"] = np_of(jcore.coreness(jg2, backend="jnp", mirror=jplan))
    want["m_cc"] = np_of(jcore.connected_components(jg2, backend="jnp",
                                                    mirror=jplan))
    want["m_pr"] = np_of(jcore.pagerank(jg2, tol=None, max_steps=PR_STEPS,
                                        backend="jnp", mirror=jplan))
    want["m_tri"] = np_of(jcore.triangle_counts(jg2, backend="jnp",
                                                mirror=jplan))
    jc = jcore.coreness(jg, backend="jnp")
    g3, core3, st = jcore.maintain_batch(_jclone(jg), jc, ups, R=4,
                                         backend="jnp")
    want.update(mb_core=np_of(core3), mb_nbr=np_of(g3.nbr),
                mb_stats=mesh_worker.stats_array(st))
    res = reference().run_stream(
        _jclone(jg), jc, ups, R=4, backend="jnp",
        cc_labels=jcore.connected_components(jg, backend="jnp"))
    for p in ("st_", "rs_"):  # the restored stream ends where it would have
        want.update({p + "core": np_of(res.core),
                     p + "labels": np_of(res.labels),
                     p + "nbr": np_of(res.g.nbr),
                     p + "stats": mesh_worker.stats_array(res.stats)})
    return want


@pytest.fixture(scope="module")
def programs(tmp_path_factory):
    """(case, reference results, the W = 1 mesh run in this process)."""
    jg, js = _graphs()
    ups = (jupd.sample_insertions(jg, 4, "inter", seed=2)
           + jupd.sample_insertions(jg, 4, "intra", seed=3)
           + jupd.sample_deletions(jg, 4, "inter", seed=4)
           + jupd.sample_deletions(jg, 4, "intra", seed=5))
    tg, ts = to_port(jg), to_port(js)
    case = dict(tg.to_numpy(), P=np.asarray(P), Cn=np.asarray(tg.Cn),
                Cd=np.asarray(tg.Cd), pr_steps=np.asarray(PR_STEPS),
                threshold=np.asarray(THRESHOLD),
                restore_at=np.asarray(RESTORE_AT),
                ups=np.asarray(ups, np.int64),
                core=np_of(jcore.coreness(jg, backend="jnp")),
                labels=np_of(jcore.connected_components(jg, backend="jnp")),
                s_Cn=np.asarray(ts.Cn), s_Cd=np.asarray(ts.Cd),
                **{"s_" + k: v for k, v in ts.to_numpy().items()})
    want = _want(jg, js, ups)
    w1 = mesh_worker.run_programs(dict(
        case, out_dir=np.asarray(str(tmp_path_factory.mktemp("w1")))))
    return case, want, w1


def _check(res, want, w1, W):
    assert int(res["W"]) == W
    assert int(res["plan_builds"]) == 0  # one executor, never rebuilt
    for k, v in want.items():
        got = res[k]
        if k in FLOATS:
            np.testing.assert_allclose(got, v, rtol=0, atol=FLOAT_ATOL,
                                       err_msg=f"W={W} {k}")
        elif k.endswith("stats") and k[:3] in ("st_", "rs_"):
            # every StreamStats field but the plan counters (the single-
            # device reference keeps none), which equal the W = 1 mesh run
            pc = slice(8 + P, 10 + P)
            np.testing.assert_array_equal(np.delete(got, pc),
                                          np.delete(v, pc), err_msg=k)
            np.testing.assert_array_equal(got[pc], w1[k][pc], err_msg=k)
            assert got[pc][0] > 0 and got[pc][1] == 0
        else:
            np.testing.assert_array_equal(got, v, err_msg=f"W={W} {k}")


def test_w1_programs_equal_reference(programs):
    case, want, w1 = programs
    _check(w1, want, w1, 1)


@pytest.mark.parametrize("W", (2, 4, 8))
def test_gloo_programs_equal_single_device_reference(W, programs, tmp_path):
    case, want, w1 = programs
    results = mesh_worker.spawn_mesh(
        W, dict(case, out_dir=np.asarray(str(tmp_path))), tmp_path,
        body="run_programs")
    assert len(results) == W
    for res in results:
        _check(res, want, w1, W)
