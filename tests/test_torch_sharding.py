"""PyTorch port vs the JAX package: the sharding rules
(`repro_torch.distributed.sharding` against `repro.distributed.sharding`).

The reference's rules accept a device-free `jax.sharding.AbstractMesh`,
so they are held here at the production mesh shapes on one CPU:
(1, 1), (2, 4), (16, 16) and (2, 16, 16) (the last with a ``pod`` axis).
Every spec must be EQUAL to the reference's (`PartitionSpec` as the tuple
of its entries; jax writes a tuple of one axis name as the name, and so
does the port's).  The inputs:

* every parameter leaf of all ten architectures at full size, with its
  path (`param_spec`, `zero_spec`, `param_shardings`); the port's shapes
  from `init` on the meta device, the reference's from `jax.eval_shape`;
* every cache leaf of the decode shapes (`decode_32k`, and `long_500k`
  where the architecture runs it; ring caches too), `cache_shardings`
  and `cache_sharding`;
* `batch_spec`, `dp_axes`, `dp_size` over batch sizes;
* the reference's own cases of `tests/test_sharding_and_specs.py`.
"""
import functools

import jax
import pytest
from jax.sharding import AbstractMesh

import repro.configs as jcfg
from repro.distributed import sharding as JSH
from repro.models import build as jbuild

import repro_torch.configs as tcfg
from repro_torch.distributed import sharding as SH
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import build

ARCHS = sorted(jcfg.ARCHS)
MESHES = [((1, 1), ("data", "model")), ((2, 4), ("data", "model")),
          ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]


def _meshes():
    """(reference AbstractMesh, port Mesh) pairs of every shape."""
    return [(AbstractMesh(s, n), SH.Mesh(n, s)) for s, n in MESHES]


def _ref_leaves(tree):
    """{path: leaf} of a jax tree, paths as the reference writes them."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {JSH._path_str(p): leaf for p, leaf in flat}


def _port_leaves(tree):
    out = {}
    SH._tree_map_with_path(
        lambda p, leaf: out.__setitem__(SH._path_str(p), leaf), tree)
    return out


@functools.lru_cache(maxsize=None)
def _param_shapes(name):
    """({path: shape} of the reference, of the port) at full size."""
    ref = jax.eval_shape(jbuild(jcfg.ARCHS[name]).init,
                         jax.random.PRNGKey(0))
    port = build(tcfg.ARCHS[name]).init(0, device="meta")
    for leaf in _port_leaves(port).values():
        assert leaf.device.type == "meta"
    return ({p: tuple(x.shape) for p, x in _ref_leaves(ref).items()},
            {p: tuple(x.shape) for p, x in _port_leaves(port).items()})


@pytest.mark.parametrize("name", ARCHS)
def test_param_specs_equal_reference(name):
    ref, port = _param_shapes(name)
    assert port == ref
    for jm, tm in _meshes():
        shard = _port_leaves(SH.param_shardings(
            build(tcfg.ARCHS[name]).init(0, device="meta"), tm))
        for path, shape in ref.items():
            rs = JSH.param_spec(path, shape, jm)
            ps = SH.param_spec(path, shape, tm)
            assert tuple(ps) == tuple(rs), (path, shape, tm)
            assert shard[path].spec == ps and shard[path].mesh == tm
            assert tuple(SH.zero_spec(ps, shape, tm)) == \
                tuple(JSH.zero_spec(rs, shape, jm)), (path, shape, tm)


def _cache_cases(name):
    """(shape name, ring) of the decode cells this architecture runs."""
    cfg = jcfg.ARCHS[name]
    out = []
    for s in ("decode_32k", "long_500k"):
        if jcfg.cell_applicable(cfg, jcfg.SHAPES_BY_NAME[s])[0]:
            out.append((s, False))
            if cfg.sliding_window and not cfg.is_encdec:
                out.append((s, True))
    return out


@pytest.mark.parametrize("name", ARCHS)
def test_cache_specs_equal_reference(name):
    jb, tb = jbuild(jcfg.ARCHS[name]), build(tcfg.ARCHS[name])
    for shape_name, ring in _cache_cases(name):
        sc = jcfg.SHAPES_BY_NAME[shape_name]
        B, S = sc.global_batch, sc.seq_len
        ring_kw = {"ring": ring} if not jcfg.ARCHS[name].is_encdec else {}
        ref = jax.eval_shape(functools.partial(jb.cache_init, B, S,
                                               **ring_kw))
        port = tb.cache_init(B, S, device="meta", **ring_kw)
        rl, pl = _ref_leaves(ref), _port_leaves(port)
        assert {p: tuple(x.shape) for p, x in pl.items()} == \
            {p: tuple(x.shape) for p, x in rl.items()}
        for jm, tm in _meshes():
            rsh = _ref_leaves(JSH.cache_shardings(ref, jm))
            psh = _port_leaves(SH.cache_shardings(port, tm))
            for path, leaf in rl.items():
                assert tuple(psh[path].spec) == tuple(rsh[path].spec), (
                    path, leaf.shape, tm)
                for kind in ("kv", "mla", "ssm", "conv"):
                    nd = {"kv": 5, "ssm": 5, "mla": 4, "conv": 4}[kind]
                    if len(leaf.shape) < nd:
                        continue
                    assert tuple(SH.cache_sharding(
                        tm, leaf.shape, kind).spec) == tuple(
                        JSH.cache_sharding(jm, leaf.shape, kind).spec)


def test_batch_specs_equal_reference():
    for jm, tm in _meshes():
        assert SH.dp_axes(tm) == JSH.dp_axes(jm)
        assert SH.dp_size(tm) == JSH.dp_size(jm)
        for B in (1, 2, 3, 4, 8, 16, 32, 96, 128, 256, 512, 1024):
            for extra in (0, 1, 2):
                assert tuple(SH.batch_spec(tm, B, extra)) == \
                    tuple(JSH.batch_spec(jm, B, extra)), (B, extra, tm)


def test_cache_sharding_production_example():
    """The reference's long-context kv layout on the multi-pod mesh: the
    sequence over every axis."""
    jm, tm = _meshes()[3]
    shape = (24, 1, 524288, 8, 128)
    assert tuple(SH.cache_sharding(tm, shape, "kv").spec) == tuple(
        JSH.cache_sharding(jm, shape, "kv").spec) == (
        None, None, ("pod", "data", "model"), None, None)


# ---------------------------------------------------------------------------
# the reference's own cases (tests/test_sharding_and_specs.py), on the port
# ---------------------------------------------------------------------------

def test_param_spec_rules():
    mesh = make_test_mesh(dp=1, tp=1)
    P = SH.P
    assert SH.param_spec("embed/w", (512, 64), mesh) == P(None, None)
    m = SH.Mesh(("data", "model"), (1, 4))
    assert SH.param_spec("embed/w", (512 * 4, 64), m)[0] == "model"
    # fallback replication for non-divisible dims
    assert SH.param_spec("wk/w", (64, 7), m) == P(None, None)
    # stacked leading dims padded with None
    s = SH.param_spec("blocks/0/attn/wq/w", (24, 64, 128), mesh)
    assert len(s) == 3 and s[0] is None


def test_zero_spec_adds_data_axis():
    m = SH.Mesh(("data", "model"), (4, 1))
    out = SH.zero_spec(SH.P(None, None), (16, 8), m)
    assert out[0] == "data"
    out2 = SH.zero_spec(SH.P("model", None), (16, 8), m)
    assert out2[0] == "model"  # never overrides existing axes


def test_batch_spec_divisibility():
    mesh = make_test_mesh(dp=1, tp=1)
    assert SH.batch_spec(mesh, 8, 1) == SH.P(("data",), None)
    assert SH.batch_spec(mesh, 8, 1) == ("data", None)
    m = SH.Mesh(("data", "model"), (4, 1))
    assert SH.batch_spec(m, 3, 1) == SH.P(None, None)  # non-divisible


def test_cache_shardings_classify():
    import torch

    mesh = make_test_mesh(dp=1, tp=1)
    shapes = {
        "k": torch.empty((4, 8, 32, 2, 16), dtype=torch.bfloat16,
                         device="meta"),
        "state": torch.empty((4, 8, 4, 16, 8), device="meta"),
        "conv": torch.empty((4, 8, 3, 64), device="meta"),
    }
    sh = SH.cache_shardings(shapes, mesh)
    assert set(sh.keys()) == set(shapes.keys())
    assert all(isinstance(s, SH.NamedSharding) for s in sh.values())
