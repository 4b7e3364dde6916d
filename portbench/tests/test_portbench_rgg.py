"""The rgg generator, its partition by position, the local_stream
driver's layout and pool, the two readers of the block-local path, and
faults planted in the stream's timed path of the local_stream cells, at
small n on the CPU."""
import hashlib
import time

import pytest
import torch

from _tiny import tiny_cell
from portbench.harness import graphs, runner, spec
from portbench.harness.record import RunRecord
from portbench.harness import trace

rgg = spec.load_generator("rgg")
drv = spec.load_driver("local_stream")

SEED = 2**31 + 101
CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]
         if spec.load_traffic(w["traffic"])["driver"] == "local_stream"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread: several test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def gen(seed):
    return torch.Generator().manual_seed(seed)


def conf(scale, blocks=8):
    return dict(generator="rgg", scale=scale, vertices=1 << scale,
                radius_factor=0.55, blocks=blocks)


def placed(scale, seed, blocks=8):
    """The points at each id, as the generator numbers them."""
    xy = rgg.points(1 << scale, gen(seed))
    return xy[rgg.bisection_order(xy, rgg.levels_of(blocks))]


@pytest.mark.parametrize("scale,seed", [(10, 2**31 + 5), (11, 7)])
def test_rgg_equals_an_all_pairs_distance_check(scale, seed):
    n = 1 << scale
    keys = rgg.edges(conf(scale), gen(seed))
    xy = placed(scale, seed)
    r = rgg.radius(n, 0.55)
    near = (xy[:, None, :] - xy[None, :, :]).square().sum(-1) < r * r
    i, j = torch.nonzero(torch.triu(near, 1), as_tuple=True)
    assert keys.dtype == torch.int64
    assert torch.equal(keys, torch.sort(i * n + j).values)


def test_rgg_edge_count_is_the_published_familys():
    """At 2^16 the rule gives the DIMACS10 graph's size in law:
    rgg_n_2_16_s0 has 342,902 edges (the 2^23 count is checked on the
    card)."""
    keys = rgg.edges(conf(16), gen(27491095))
    n = 1 << 16
    assert abs(keys.numel() / 342902 - 1) < 0.005
    assert torch.equal(keys, torch.unique(keys))
    deg = torch.bincount(torch.cat([keys // n, keys % n]), minlength=n)
    assert 25 <= int(deg.max()) <= 35


#: SHA-256 of the sorted keys' bytes (little-endian int64), on the CPU
RGG_DIGESTS = {
    12: "0a35b31895830a5c46b274f78d7558d8b5e02493e0c35eb11f1956a92b8fa789",
}


def test_rgg_gives_the_same_graph_bit_for_bit():
    keys = graphs.make_edges(conf(12), gen(27491095))
    digest = hashlib.sha256(keys.numpy().astype("<i8").tobytes()).hexdigest()
    assert digest == RGG_DIGESTS[12]


@pytest.mark.parametrize("scale,blocks", [(10, 8), (12, 8), (11, 4)])
def test_partition_is_equal_blocks_of_rectangles(scale, blocks):
    """Block b is ids [b * n / blocks, (b + 1) * n / blocks), and its
    points are those of one rectangle: at every level each part's two
    halves lie on the two sides of one line along the level's axis."""
    n = 1 << scale
    xy = placed(scale, 3, blocks)
    levels = rgg.levels_of(blocks)
    for level in range(levels):
        axis = level % 2
        halves = xy[:, axis].view(1 << level, 2, -1)
        assert bool((halves[:, 0].max(1).values
                     < halves[:, 1].min(1).values).all())
    # each leaf's extent is its share of the square
    leaves = xy.view(blocks, n // blocks, 2)
    span = leaves.max(1).values - leaves.min(1).values
    want = torch.tensor([0.5 ** ((levels + 1) // 2), 0.5 ** (levels // 2)],
                        dtype=torch.float64)
    assert torch.allclose(span, want.expand_as(span), atol=0.15)


def test_rgg_refuses_what_it_cannot_draw():
    with pytest.raises(ValueError, match="2\\^scale"):
        rgg.edges(dict(conf(10), vertices=1000), gen(1))
    with pytest.raises(ValueError, match="power of two"):
        rgg.edges(conf(10, blocks=6), gen(1))


def test_rgg23_configuration_is_what_it_states():
    cell = spec.load_cell("rgg23.local_stream")
    c = cell.config
    assert c["vertices"] == 1 << c["scale"] == 1 << 23
    assert c["blocks"] == 8 and c["reduced"] == {}
    assert c["radius_factor"] == 0.55 and c["degree_capacity"] == 48
    tiny = dict(c, **c["tiny"])
    assert tiny["vertices"] == 1 << tiny["scale"]
    assert cell.chips == 1 and cell.traffic["driver"] == "local_stream"


def _layout(scale=11, seed=9):
    n = 1 << scale
    keys = rgg.edges(conf(scale), gen(4))
    return keys, drv.lay_out_by_id(keys, n, 8, 48, gen(seed))


def test_layout_keeps_the_blocks_and_permutes_inside_them():
    keys, lay = _layout()
    n, Cn = lay.n, lay.Cn
    assert lay.N == n == 8 * Cn and lay.pop.tolist() == [Cn] * 8
    assert bool(lay.node_mask.all())
    orig = lay.orig_id
    assert torch.equal(orig // Cn, torch.arange(n) // Cn)
    assert not torch.equal(orig, torch.arange(n))
    a, b = orig[lay.keys // n], orig[lay.keys % n]
    back = torch.sort(torch.minimum(a, b) * n + torch.maximum(a, b)).values
    assert torch.equal(back, keys)
    _, again = _layout()
    assert torch.equal(again.keys, lay.keys)


def test_local_pool_is_valid_in_any_order():
    """Deletes are present edges, inserts absent pairs with a common
    neighbour, no pair twice, half each, and the same seed gives the same
    pool."""
    _, lay = _layout()
    nbr, deg = graphs.ell_rows(lay.keys, lay.N, lay.Cd)
    mix = {"delete": 0.5, "insert_two_hop": 0.5}
    ups = drv.sample_local_pool(lay, nbr, deg, 1002, mix, gen(6))
    u, v, op = ups[:, 0], ups[:, 1], ups[:, 2]
    N = lay.N
    key = torch.minimum(u, v) * N + torch.maximum(u, v)
    assert ups.shape == (1002, 3) and bool((u != v).all())
    assert torch.unique(key).numel() == key.numel()
    present = torch.isin(key, lay.keys)
    assert bool(present[op < 0].all()) and not bool(present[op > 0].any())
    assert int((op < 0).sum()) == int((op > 0).sum()) == 501
    adj = torch.zeros(N, N, dtype=torch.bool)
    adj[lay.keys // N, lay.keys % N] = True
    adj |= adj.T.clone()
    ins = op > 0
    common = (adj[u[ins]] & adj[v[ins]]).any(1)
    assert bool(common.all())
    assert not torch.equal(ups[:, 2], torch.sort(ups[:, 2]).values)
    assert torch.equal(ups, drv.sample_local_pool(lay, nbr, deg, 1002, mix,
                                                  gen(6)))
    with pytest.raises(ValueError, match="mix"):
        drv.sample_local_pool(lay, nbr, deg, 10, {"delete": 1.0}, gen(6))


WINDOW = (100, 1100)
HOST = [(0, 90, "bladyg.local"),                  # warm-up: not counted
        (105, 495, "bladyg.window"), (200, 300, "bladyg.local"),
        (250, 290, "bladyg.recompute"), (600, 1000, "bladyg.window"),
        (700, 760, "bladyg.local")]


def _run(host, **counters):
    t = trace.Trace(window=WINDOW, device=[],
                    host=[(s, e, n, False) for s, e, n in host])
    return RunRecord(cell="c", device_kind="cpu", setup_s=1.0,
                     window_s=1e-6, units=16, unit_ms=[],
                     counters=dict(dict(updates=16, windows=2), **counters),
                     sizes={}, trace=t)


def test_local_readers_give_the_hand_computed_values():
    ms = spec.load_reader("local_ms_per_window")
    cand = spec.load_reader("local_candidates_per_update")
    run = _run(HOST, block_local=15, local_candidates=1200)
    assert ms(run) == pytest.approx(1e-6 * (100 + 60) / 2)
    assert cand(run) == pytest.approx(80.0)


def test_local_readers_read_nothing_from_a_program_without_them():
    """A program with no `bladyg.local` span and no `local_candidates`
    count (the parent of the change that added them) gives no value."""
    ms = spec.load_reader("local_ms_per_window")
    cand = spec.load_reader("local_candidates_per_update")
    bare = _run([h for h in HOST if h[2] != "bladyg.local"], block_local=15)
    assert ms(bare) is None and cand(bare) is None
    assert cand(_run(HOST, block_local=0, local_candidates=0)) is None
    none = _run(HOST, block_local=15, local_candidates=10)
    none.trace = None
    assert ms(none) is None


def _unchanged(sess, window):
    """A window that returns the session's state unchanged."""


def _half(orig):
    def apply(sess, window):   # half of each window left out
        return orig(sess, window[:len(window) // 2])
    return apply


def _altered(orig):
    def apply(sess, window):   # one node's coreness altered where produced
        orig(sess, window)
        sess.core = sess.core.clone()
        sess.core[int(torch.nonzero(sess.g.node_mask)[0])] += 1
    return apply


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_local_stream_faults_come_out_not_correct(fault, name, monkeypatch):
    from repro_torch.runtime.stream import StreamSession

    orig = StreamSession.apply_window
    patch = dict(unchanged=_unchanged, half=_half(orig),
                 altered=_altered(orig))[fault]
    monkeypatch.setattr(StreamSession, "apply_window", patch)
    line, _ = runner.run_cell(tiny_cell(name), SEED, 0.3, False, "cpu",
                              time.perf_counter())
    assert line["correct"] is False, line["compared"]


@pytest.mark.parametrize("name", CELLS)
def test_program_without_the_count_still_runs(name, monkeypatch):
    """On a program whose session has no `local_candidates` (the parent
    of the change that added it) the run records no such counter and is
    correct."""
    from repro_torch.runtime.stream import StreamSession

    monkeypatch.delattr(StreamSession, "local_candidates")
    cell = tiny_cell(name)
    out = drv.run(cell, SEED, 0.3, trace.Tracer(False), "cpu",
                  time.perf_counter())
    assert "local_candidates" not in out.record.counters
    assert out.record.counters["block_local"] > 0
    line, _ = runner.result_line(
        cell, out, drv.judge(out.outputs, out.inputs, cell.traffic, "cpu"),
        False, "cpu")
    assert line["correct"] is True
