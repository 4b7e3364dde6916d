"""The plain reference against networkx and direct loops on small
graphs."""
import networkx as nx
import numpy as np
import pytest
import torch

from portbench import reference


def graph(n, m, seed, pad=0):
    """A random graph over ids [0, n) inside N = n + pad ids: (keys, N,
    node_mask, networkx graph)."""
    rng = np.random.default_rng(seed)
    G = nx.gnm_random_graph(n, m, seed=int(rng.integers(1 << 30)))
    N = n + pad
    keys = torch.tensor(sorted(min(a, b) * N + max(a, b)
                               for a, b in G.edges()), dtype=torch.int64)
    mask = torch.zeros(N, dtype=torch.bool)
    mask[:n] = True
    return keys, N, mask, G


@pytest.mark.parametrize("n,m,seed", [(60, 150, 0), (200, 900, 1),
                                      (300, 280, 2)])
def test_coreness_components_triangles(n, m, seed):
    keys, N, mask, G = graph(n, m, seed, pad=5)
    core = nx.core_number(G)
    assert reference.coreness(keys, N).tolist() == \
        [core[u] for u in range(n)] + [0] * 5
    labels = reference.component_labels(keys, N, mask).tolist()
    for comp in nx.connected_components(G):
        assert {labels[u] for u in comp} == {min(comp)}
    assert labels[n:] == [-1] * 5
    tri = nx.triangles(G)
    assert reference.triangles(keys, N, wedges_per_block=64).tolist() == \
        [tri[u] for u in range(n)] + [0] * 5


def test_pagerank_follows_its_definition():
    keys, N, mask, G = graph(80, 200, 3, pad=4)
    n = 80
    rank, steps = reference.pagerank(keys, N, mask, 0.85, 1e-9, 100)
    r = np.where(np.arange(N) < n, 1.0 / n, 0.0)
    for s in range(100):
        new = np.zeros(N)
        for u in range(n):
            new[u] = 0.15 / n + 0.85 * sum(r[v] / G.degree(v) for v in G[u])
        moved = np.abs(new - r).max() > 1e-9
        r = new
        if not moved:
            break
    assert steps == s + 1
    np.testing.assert_allclose(rank.numpy(), r, rtol=1e-12, atol=0)
    _, one = reference.pagerank(keys, N, mask, 0.85, 1.0, 100)
    assert one == 1
    fixed, thirty = reference.pagerank(keys, N, mask, 0.85, None, 30)
    assert thirty == 30 and not torch.equal(fixed, rank)


def test_replay_applies_inserts_and_deletes_and_refuses_bad_streams():
    N = 10
    keys = torch.tensor([0 * N + 1, 1 * N + 2, 3 * N + 4])
    ups = torch.tensor([[2, 1, -1], [5, 6, 1], [4, 0, 1]])
    assert reference.replay(keys, ups, N).tolist() == [1, 4, 34, 56]
    for bad in ([[1, 0, 1]], [[5, 6, -1]], [[5, 6, 1], [6, 5, -1]],
                [[3, 3, 1]]):
        with pytest.raises(ValueError):
            reference.replay(keys, torch.tensor(bad), N)
