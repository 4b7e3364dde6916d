"""The kron generator at small scales on the CPU, and the mirror_stream
driver's mapping of a split graph back onto the logical graph."""
import hashlib

import pytest
import torch

from portbench.harness import graphs, spec


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread: several test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


INITIATOR = {"A": 0.57, "B": 0.19, "C": 0.19, "D": 0.05}


def kron_conf(scale):
    return dict(generator="kron", scale=scale, vertices=1 << scale,
                edge_factor=16, initiator=INITIATOR)


def kron_edges(scale, seed=2**31 + 5):
    return graphs.make_edges(kron_conf(scale),
                             torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("scale", [10, 12, 14])
def test_kron_distinct_pairs_no_loops_and_skewed(scale):
    n = 1 << scale
    keys = kron_edges(scale)
    lo, hi = keys // n, keys % n
    assert keys.dtype == torch.int64
    assert torch.equal(keys, torch.unique(keys))
    assert bool((lo < hi).all()) and bool((hi < n).all())
    # 16 draws a vertex, some of them loops and repeats
    assert 0.5 * 16 * n < keys.numel() <= 16 * n
    deg = torch.bincount(torch.cat([lo, hi]), minlength=n)
    mean = float(deg.double().mean())
    assert int(deg.max()) > 20 * mean
    # isolated vertices are kept, as gapbs keeps them
    assert int((deg == 0).sum()) > 0


#: SHA-256 of the sorted keys' bytes (little-endian int64), on the CPU
KRON_DIGESTS = {
    10: "51941e89edb16f3bd3a08889ec73e0df5d989251707d3bfaf18334b44cd54214",
    12: "b9e2e0cffd2962124a72b4fc80dee636e3d84f07bb187cd1c8e61559cc6a6fe8",
}


@pytest.mark.parametrize("scale", sorted(KRON_DIGESTS))
def test_kron_gives_the_same_graph_bit_for_bit(scale):
    keys = kron_edges(scale)
    digest = hashlib.sha256(keys.numpy().astype("<i8").tobytes()).hexdigest()
    assert digest == KRON_DIGESTS[scale]


def test_kron_refuses_vertices_other_than_two_to_the_scale():
    conf = dict(kron_conf(10), vertices=1000)
    with pytest.raises(ValueError, match="2\\^scale"):
        graphs.make_edges(conf, torch.Generator().manual_seed(1))


def test_kron23_configuration_is_what_it_states():
    conf = spec.load_cell("kron23.mirror_stream").config
    assert conf["vertices"] == 1 << conf["scale"] == 1 << 23
    assert conf["degree_capacity"] == conf["hub_threshold"] == 64
    assert conf["node_capacity"] * conf["blocks"] > conf["vertices"]
    tiny = dict(conf, **conf["tiny"])
    assert tiny["vertices"] == 1 << tiny["scale"]


@pytest.mark.parametrize("threshold", [8, 16])
def test_logical_outputs_give_back_the_unsplit_graph(threshold):
    """The driver's view of a split graph equals the unsplit graph's edge
    slots, degrees and coreness (padding rows 0)."""
    from repro_torch.core import kcore
    from repro_torch.core.graph import build_blocks
    from repro_torch.core.hub_split import build_split_blocks

    drv = spec.load_driver("mirror_stream")
    n, P = 1 << 10, 4
    keys = kron_edges(10)
    edges = torch.stack([keys // n, keys % n], 1)
    assign = torch.randint(0, P, (n,), generator=torch.Generator()
                           .manual_seed(3))
    g = build_blocks(edges.numpy(), n, assign.numpy(), P, node_slack=900,
                     device="cpu")
    g2, plan = build_split_blocks(edges, n, assign, P, threshold,
                                  Cn=g.Cn, device="cpu")
    core = kcore.coreness(g2, backend="torch", mirror=plan)
    out = drv.logical_outputs(g2, plan, core)
    rows = torch.arange(g.N)[:, None].expand_as(g.nbr)
    valid = g.nbr >= 0
    want = torch.sort(rows[valid] * g.N + g.nbr[valid].long()).values
    assert torch.equal(out["slots"], want)
    assert torch.equal(out["nslots"], g.deg.long())
    assert torch.equal(out["deg"].long(), g.deg.long())
    assert torch.equal(out["core"], kcore.coreness(g, backend="torch"))
    sizes = drv.group_sizes(g2, plan)
    assert sizes["sum_deg"] == int(g.deg.sum())
    assert sizes["groups"] == int((g.deg > threshold).sum())
