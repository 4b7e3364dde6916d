"""The generators, the block layout, the ELL rows and the update pool at
small n on the CPU."""
import hashlib

import pytest
import torch

from portbench.harness import graphs, pool, spec

urand = spec.load_generator("urand")


def gen(seed):
    return torch.Generator().manual_seed(seed)


def urand_edges(n, m, g):
    return urand.edges(dict(vertices=n, edges=m), g)


@pytest.mark.parametrize("n,m", [(1000, 16000), (4096, 65536)])
def test_urand_exact_and_uniform_pairs(n, m):
    keys = urand_edges(n, m, gen(2**31 + 5))
    lo, hi = keys // n, keys % n
    assert keys.numel() == m == torch.unique(keys).numel()
    assert bool((lo < hi).all()) and bool((hi < n).all())
    assert torch.equal(keys, torch.sort(keys).values)
    deg = torch.bincount(torch.cat([lo, hi]), minlength=n)
    assert abs(float(deg.double().mean()) - 2 * m / n) < 1e-9


@pytest.mark.parametrize("n,m", [(1 << 12, 1 << 16), (1 << 14, 1 << 18)])
def test_urand_degrees_stay_under_the_configured_capacity(n, m):
    """Mean degree 32 as GAP's urand: the largest degree at these sizes
    stays well under the 80 slots `urand23` gives a row, as at 2^23."""
    keys = urand_edges(n, m, gen(2**31 + 9))
    deg = torch.bincount(torch.cat([keys // n, keys % n]), minlength=n)
    assert float(deg.double().mean()) == 32.0
    assert 32 < int(deg.max()) < 80 and int(deg.min()) > 0


#: SHA-256 of the sorted keys' bytes (little-endian int64) that the
#: generator gave before it moved into its own file, on the CPU
URAND_DIGESTS = {
    (1000, 16000):
        "a202bfeba70cf0925c23413da85675fd241f83c53637689d50d36c2b36726b88",
    (4096, 65536):
        "b0693bc5ec3d7f1d4ad4c7c9a2b18e9b9469239796b5261f9bb7e8d2877f1945",
}


@pytest.mark.parametrize("n,m", sorted(URAND_DIGESTS))
def test_urand_gives_the_same_graph_bit_for_bit(n, m):
    keys = graphs.make_edges(dict(generator="urand", vertices=n, edges=m),
                             gen(2**31 + 5))
    assert keys.dtype == torch.int64
    digest = hashlib.sha256(keys.numpy().astype("<i8").tobytes()).hexdigest()
    assert digest == URAND_DIGESTS[n, m]


def test_unknown_generator_is_refused():
    with pytest.raises(ValueError, match="portbench/generators/lattice.py"):
        graphs.make_edges(dict(generator="lattice", vertices=100,
                               edges=150), gen(1))


@pytest.mark.parametrize("n,m", [(512, 4096), (2048, 32768)])
def test_same_seed_same_graph(n, m):
    conf = dict(generator="urand", vertices=n, edges=m, blocks=8,
                degree_capacity=80, graph_seed=27491095)
    a, b = graphs.make_layout(conf, gen(7)), graphs.make_layout(conf, gen(7))
    c = graphs.make_layout(conf, gen(8))
    assert torch.equal(a.keys, b.keys) and torch.equal(a.orig_id, b.orig_id)
    assert not torch.equal(a.keys, c.keys)
    # another run seed relabels the same graph: one degree sequence
    assert torch.equal(
        torch.sort(torch.bincount(a.keys // a.N, minlength=a.N)
                   + torch.bincount(a.keys % a.N, minlength=a.N)).values,
        torch.sort(torch.bincount(c.keys // c.N, minlength=c.N)
                   + torch.bincount(c.keys % c.N, minlength=c.N)).values)
    other = dict(conf, graph_seed=1)
    assert not torch.equal(graphs.make_layout(other, gen(7)).keys, a.keys)


def test_relabel_is_an_isomorphism():
    n = 200
    keys = urand_edges(n, 1000, gen(2))
    g = gen(3)
    perm = torch.randperm(n, generator=gen(3))
    got = graphs.relabel(keys, n, g)
    a, b = perm[keys // n], perm[keys % n]
    want = torch.sort(torch.minimum(a, b) * n + torch.maximum(a, b)).values
    assert torch.equal(got, want) and not torch.equal(got, keys)


def test_layout_is_balanced_random_and_block_contiguous():
    n, P = 1003, 8
    lay = graphs.lay_out(urand_edges(n, 8000, gen(1)), n, P, 80,
                         gen(2))
    assert lay.Cn == 128 and lay.N == P * 128
    assert lay.pop.tolist() == [126] * 3 + [125] * 5
    for b in range(P):
        block = lay.node_mask[b * lay.Cn:(b + 1) * lay.Cn]
        assert bool(block[:lay.pop[b]].all()) and not bool(
            block[lay.pop[b]:].any())
    real = lay.orig_id[lay.node_mask]
    assert torch.equal(torch.sort(real).values, torch.arange(n))
    for b in range(P):   # original order inside each block
        ids = lay.orig_id[b * lay.Cn:b * lay.Cn + int(lay.pop[b])]
        assert bool((ids[1:] > ids[:-1]).all())
    lo, hi = lay.keys // lay.N, lay.keys % lay.N
    assert bool(lay.node_mask[lo].all() and lay.node_mask[hi].all())


def test_ell_rows_keep_the_sorted_ell_invariant():
    lay = graphs.make_layout(dict(generator="urand", vertices=300,
                                  edges=2000, blocks=4, degree_capacity=40,
                                  graph_seed=3),
                             gen(4))
    nbr, deg = graphs.ell_rows(lay.keys, lay.N, lay.Cd)
    assert nbr.dtype == deg.dtype == torch.int32
    for u in range(lay.N):
        d = int(deg[u])
        row = nbr[u]
        assert bool((row[d:] == -1).all()) and bool((row[:d] >= 0).all())
        assert d < 2 or bool((row[1:d] > row[:d - 1]).all())
    assert int(deg.sum()) == 2 * lay.keys.numel()
    with pytest.raises(ValueError):
        graphs.ell_rows(lay.keys, lay.N, int(deg.max()) - 1)


def test_pool_is_valid_in_any_order():
    lay = graphs.make_layout(dict(generator="urand", vertices=1024,
                                  edges=8192, blocks=8, degree_capacity=80,
                                  graph_seed=4),
                             gen(5))
    mix = dict(insert_inter=0.25, insert_intra=0.25, delete_inter=0.25,
               delete_intra=0.25)
    ups = pool.sample_pool(lay, 1002, mix, gen(6))
    u, v, op = ups[:, 0], ups[:, 1], ups[:, 2]
    assert ups.shape == (1002, 3)
    key = torch.minimum(u, v) * lay.N + torch.maximum(u, v)
    assert torch.unique(key).numel() == key.numel()       # no pair twice
    present = torch.isin(key, lay.keys)
    assert bool(present[op < 0].all())                    # deletes exist
    assert not bool(present[op > 0].any())                # inserts absent
    assert bool((u != v).all())
    assert bool(lay.node_mask[u].all() and lay.node_mask[v].all())
    intra = (u // lay.Cn) == (v // lay.Cn)
    got = {c: int(((op == o) & (intra == i)).sum())
           for c, (o, i) in pool.CLASSES.items()}
    assert got == pool.class_counts(1002, mix)
    assert sorted(got.values()) == [250, 250, 251, 251]
    load = pool.insert_load(ups, lay.N)
    assert int(load.sum()) == 2 * int((op > 0).sum())
    assert not torch.equal(ups, pool.sample_pool(lay, 1002, mix, gen(7)))
    assert torch.equal(ups, pool.sample_pool(lay, 1002, mix, gen(6)))
