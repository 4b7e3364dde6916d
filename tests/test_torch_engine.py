"""PyTorch port vs the JAX package: the superstep engine.

`coreness_via_engine` (the paper's message-accounting run of
`CorenessProgram` through `BladygEngine.run`) must give the JAX package's
coreness, superstep traces and `message_totals()` EXACTLY; `run_jit`
(one host read per `SYNC_EVERY` supersteps) the same as JAX's fused
`run_jit`.  The halo counters, the program contract (hash/eq, the default
`changed`, `MultiProgram` validation) and the tree helpers are checked
here too.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from _torch_port import (  # noqa: F401 (fixtures)
    needs_cuda, one_torch_thread, require_cuda, to_port)

import repro.core as jcore
import repro.core.partition as jpart
import repro.graphgen as jgen
from repro.core import engine as jeng
from repro.core import kcore as jkcore

import repro_torch.core as tcore
from repro_torch.core import algorithms as talg
from repro_torch.core import engine as teng
from repro_torch.core import kcore as tkcore
from repro_torch.kernels import ops

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _blocks(kind, seed=2, P=4):
    if kind == "ba":
        edges = jgen.barabasi_albert(200, 4, seed=11)
    else:  # a long path: many supersteps, several SYNC_EVERY chunks
        edges = np.stack([np.arange(60), np.arange(1, 61)], 1)
    n = int(edges.max()) + 1
    assign = jpart.node_random_partition(n, P, seed=seed)
    return jcore.build_blocks(edges, n, assign, P=P, deg_slack=8)


@pytest.mark.parametrize("backend", ["torch", "ell"])
@pytest.mark.parametrize("kind", ["ba", "path"])
def test_coreness_via_engine_equals_reference(kind, backend):
    jg = _blocks(kind)
    want, jeng_ = jcore.coreness_via_engine(jg)
    got, eng = tcore.coreness_via_engine(to_port(jg), backend=backend)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert len(eng.traces) == len(jeng_.traces)
    assert tuple(eng.message_totals()) == tuple(jeng_.message_totals())
    assert [t.step for t in eng.traces] == [t.step for t in jeng_.traces]
    assert [tuple(t.stats) for t in eng.traces] == \
        [tuple(t.stats) for t in jeng_.traces]
    tot = eng.message_totals()
    assert tot.w2w_inter > 0 and tot.w2m == len(eng.traces)


@pytest.mark.parametrize("max_supersteps", [10_000, 3, 9])
@pytest.mark.parametrize("kind", ["ba", "path"])
def test_run_jit_equals_reference(kind, max_supersteps):
    jg = _blocks(kind)
    tg = to_port(jg)
    est0 = jnp.where(jg.node_mask, jg.deg, 0).astype(jnp.int32)
    je = jeng.BladygEngine(jg)
    want, _ = je.run_jit(jkcore.CorenessProgram(), est0, None, None,
                         max_supersteps=max_supersteps)
    te = teng.BladygEngine(tg)
    got, _ = te.run_jit(tkcore.CorenessProgram(),
                        torch.where(tg.node_mask, tg.deg, 0), None, None,
                        max_supersteps=max_supersteps)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert len(te.traces) == len(je.traces)
    assert tuple(te.message_totals()) == tuple(je.message_totals())


@pytest.mark.parametrize("P", [1, 3, 4])
def test_halo_counts_equal_reference(P):
    jg = _blocks("ba", seed=P, P=P)
    tg = to_port(jg)
    assert tcore.halo_slot_counts(tg) == jcore.halo_slot_counts(jg)
    np.testing.assert_array_equal(tcore.halo_pair_counts(tg),
                                  jcore.halo_pair_counts(jg))
    pairs = tcore.halo_pair_counts(tg)
    intra, inter = tcore.halo_slot_counts(tg)
    assert (np.trace(pairs), pairs.sum() - np.trace(pairs)) == (intra, inter)


def test_program_contract():
    pr = talg.PageRankProgram
    assert pr(tol=1e-4) == pr(tol=1e-4) and pr(tol=1e-4) != pr(tol=None)
    assert hash(pr(alpha=0.9)) == hash(pr(alpha=0.9))
    assert talg.ConnectedComponentsProgram() != talg.CorenessBlockProgram()
    multi = teng.MultiProgram((talg.CorenessBlockProgram(), pr(tol=None)),
                              max_steps=7)
    assert multi == teng.MultiProgram(
        (talg.CorenessBlockProgram(), pr(tol=None)), max_steps=7)
    assert multi.combines == ("hindex", "sum")
    assert multi.halo_fill == (-1, 0.0)
    with pytest.raises(ValueError, match="not fusable"):
        teng.MultiProgram((talg.TriangleCountProgram(),))
    with pytest.raises(ValueError, match="at least one"):
        teng.MultiProgram(())
    prog = teng.BlockProgram()
    a = (torch.zeros(3), (torch.ones(2, dtype=torch.int32),))
    b = (torch.zeros(3), (torch.tensor([1, 2], dtype=torch.int32),))
    assert not bool(prog.changed(a, a)) and bool(prog.changed(a, b))
    assert len(teng.tree_leaves((a, None, [b]))) == 4
    sel = ops.tree_where(torch.tensor(False), b, a)
    assert torch.equal(sel[1][0], a[1][0]) and ops.tree_where(
        torch.tensor(True), None, None) is None


def test_meter_counts_leaves():
    stats = teng.BladygEngine._meter(
        (torch.zeros(4, 2), torch.tensor(True)), None, (5, 6))
    assert tuple(stats) == (0, 9, 5, 6)


@needs_cuda
def test_coreness_via_engine_on_gpu():
    jg = _blocks("ba")
    want, jeng_ = jcore.coreness_via_engine(jg)
    got, eng = tcore.coreness_via_engine(to_port(jg, device="cuda"))
    np.testing.assert_array_equal(got.cpu().numpy(), np.asarray(want))
    assert tuple(eng.message_totals()) == tuple(jeng_.message_totals())
