"""PyTorch port vs the JAX package: the dry run (`repro_torch.launch.dryrun`,
`repro_torch.launch.extrapolate` against `repro.launch.dryrun` and
`repro.launch.extrapolate`).

* `group_counts`, `with_counts` and `probe_points` equal the reference's
  for all ten architectures.  The reference's two modules set XLA_FLAGS
  and REPRO_SCAN_UNROLL=1 when imported, so they run in a subprocess.
* The local shard shape of every parameter, optimizer, batch and cache
  leaf of `abstract_cell` on a fake group of 256 (16 x 16) or 512
  (2 x 16 x 16) ranks, for every applicable (architecture × shape),
  equals the reference's `NamedSharding.shard_shape` on a device-free
  `AbstractMesh`, EQUAL.
* A reduced cell's counts on a fake 4-rank group (FLOPs, bytes, the
  collectives by kind and bytes) equal, EXACTLY, what the same counter
  records on rank 0 of a real 4-rank gloo group running the same step
  (`tests/_torch_mesh_worker.py: run_cells`): a training step and a
  decode step into a cache sharded along its positions, whose logits
  and written cache also equal one process's plain decode (float32,
  within 1e-5 of the largest |value|: the sharded softmax sums in
  another order).
* The extrapolated counts equal the full-depth ones, EXACTLY (eager
  PyTorch runs every layer's ops alike), on a mesh without ZeRO and on
  one whose ``data`` divides the probes and the real depth alike.
* `run_cell` refuses a group that exists, records SKIP cells, and
  `main` returns its failures.

Every fake group made here is destroyed before the test returns.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import NamedSharding as JNamedSharding

import repro.configs as jcfg
from repro import optim as joptim
from repro.distributed import sharding as JSH
from repro.launch import specs as JSP

from _torch_mesh_worker import spawn_mesh
from _torch_port import one_torch_thread  # noqa: F401 (fixture)

import repro_torch.configs as tcfg
from repro_torch import optim
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed import sharding as SH
from repro_torch.launch import dryrun as DR
from repro_torch.launch import extrapolate as EX
from repro_torch.launch import specs as SP

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = Path(__file__).resolve().parents[1]
ARCHS = sorted(jcfg.ARCHS)
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
#: the reduced cells of the count comparison (a training step; a decode
#: step with B = 1, whose cache shards its positions over both axes)
TRAIN_TINY = ShapeConfig("train_tiny", "train", 32, 4)
DECODE_TINY = ShapeConfig("decode_tiny", "decode", 64, 1)
#: the decode step's logits and cache against one process's, relative to
#: the largest |value| (float32; the sharded softmax sums in another order)
DECODE_TOL = 1e-5


_REF_COUNTS = textwrap.dedent("""
    import json
    from repro.configs import ARCHS
    from repro.launch import extrapolate as EX
    out = {}
    for name, cfg in sorted(ARCHS.items()):
        names, real = EX.group_counts(cfg)
        pts = EX.probe_points(real)
        out[name] = {"names": names, "real": real,
                     "pts": [list(p) for p in pts],
                     "cfgs": [[getattr(EX.with_counts(cfg, names, p), f)
                               for f in ("n_layers", "first_k_dense",
                                         "enc_layers")] for p in pts]}
    print(json.dumps(out))
""")


def test_group_counts_equal_reference():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", _REF_COUNTS],
                       capture_output=True, text=True, env=env, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    ref = json.loads(r.stdout.strip().splitlines()[-1])
    assert sorted(ref) == sorted(tcfg.ARCHS)
    for name, want in ref.items():
        cfg = tcfg.ARCHS[name]
        names, real = EX.group_counts(cfg)
        pts = EX.probe_points(real)
        assert (names, real, [list(p) for p in pts]) == (
            want["names"], want["real"], want["pts"]), name
        assert [[getattr(EX.with_counts(cfg, names, p), f)
                 for f in ("n_layers", "first_k_dense", "enc_layers")]
                for p in pts] == want["cfgs"], name


def _cells(arch):
    return [s.name for s in jcfg.SHAPES
            if jcfg.cell_applicable(jcfg.ARCHS[arch], s)[0]
            and not (arch == "seamless-m4t-large-v2"
                     and s.name.startswith(("decode", "long")))]


def _ref_shard_shapes(arch, shape, sizes, names):
    mesh = AbstractMesh(sizes, names)
    _, kw, _ = JSP.abstract_cell(jcfg.ARCHS[arch], jcfg.SHAPES_BY_NAME[shape],
                                 mesh, joptim.AdamWConfig())
    import jax

    flat, _ = jax.tree_util.tree_flatten_with_path(kw)
    return {JSH._path_str(p): tuple(JNamedSharding(
        mesh, leaf.sharding.spec).shard_shape(leaf.shape))
        for p, leaf in flat}


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_local_shard_shapes_equal_reference(arch, mesh_name):
    """Every leaf's local shard on the fake group, by path, against the
    reference's shard shape (seamless-m4t's decode cells raise TypeError
    in both packages: `test_torch_specs.py`)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    import torch.distributed as dist

    sizes, names = MESHES[mesh_name]
    mesh = SH.Mesh(names, sizes)
    DR.fake_group(mesh.size)
    try:
        dmesh = SH.device_mesh(mesh, "cpu")
        for shape in _cells(arch):
            ref = _ref_shard_shapes(arch, shape, sizes, names)
            with FakeTensorMode():
                _, kw, _ = SP.abstract_cell(
                    tcfg.ARCHS[arch], tcfg.SHAPES_BY_NAME[shape], mesh,
                    optim.AdamWConfig(), device_mesh=dmesh)
                got = {}
                SH._tree_map_with_path(
                    lambda p, t: got.__setitem__(
                        SH._path_str(p), tuple(t.to_local().shape)
                        if isinstance(t, torch.Tensor) else ()), kw)
            assert got == ref, (arch, shape)
    finally:
        dist.destroy_process_group()


def _tiny_cfg():
    return dataclasses.replace(tcfg.ARCHS["internlm2-1.8b"].reduced(),
                               dtype="float32")


@pytest.fixture(scope="module")
def gloo_cells(tmp_path_factory):
    case = {"arch": np.array("internlm2-1.8b"), "seed": np.array(3),
            "train": np.array([TRAIN_TINY.seq_len, TRAIN_TINY.global_batch]),
            "decode": np.array([DECODE_TINY.seq_len,
                                DECODE_TINY.global_batch])}
    return spawn_mesh(4, case, tmp_path_factory.mktemp("cells"),
                      body="run_cells")


@pytest.mark.parametrize("shape", [TRAIN_TINY, DECODE_TINY],
                         ids=lambda s: s.name)
def test_fake_counts_equal_gloo(gloo_cells, shape):
    m = DR.measure_cell(_tiny_cfg(), shape, SH.Mesh(("data", "model"),
                                                    (2, 2)), device="cpu")
    r = gloo_cells[0]
    p = shape.kind + "_"
    assert m["flops"] == float(r[p + "flops"]) > 0
    assert m["bytes"] == float(r[p + "bytes"]) > 0
    kinds = json.loads(str(r[p + "kinds"]))
    assert m["coll_by_kind"] == kinds and kinds


def test_sharded_decode_equals_one_process(gloo_cells):
    """The decode step of `run_cells` (cache sharded along its positions
    over both axes, written at a position inside one rank's slice) against
    one process's plain decode of the same inputs."""
    from repro_torch.models import build

    cfg = _tiny_cfg()
    b = build(cfg)
    params = b.init(3, device="cpu")
    S, B = DECODE_TINY.seq_len, DECODE_TINY.global_batch
    caches = b.cache_init(B, S, device="cpu")
    g = torch.Generator().manual_seed(3)
    prompt = torch.randint(0, cfg.vocab, (B, 20), generator=g)
    _, caches = b.decode_fn(params, prompt, caches, 0)
    token = torch.randint(0, cfg.vocab, (B, 1), generator=g)
    logits, caches = b.decode_fn(params, token, caches, 20)
    r = gloo_cells[0]
    for got, want in ((r["decode_logits"], logits),
                      (r["decode_k0"], caches[0]["k"])):
        want = want.numpy()
        assert np.abs(got - want).max() <= DECODE_TOL * np.abs(want).max()


@pytest.mark.parametrize("arch,counts,sizes", [
    ("internlm2-1.8b", [5], (1, 4)),                 # n_layers
    ("seamless-m4t-large-v2", [3, 1], (1, 4)),       # enc_layers, n_layers
    ("internlm2-1.8b", [4], (2, 2)),                 # ZeRO over data
])
def test_extrapolation_equals_full_depth(arch, counts, sizes):
    """The affine fit through the probes, at the real depths, against
    the cell counted at those depths (reduced widths, a fake group).
    With ZeRO (data > 1) the stacked leaves' layer dim is sharded when
    data divides it, so the probes (depths 2 and 6) and the real depth
    must agree in that (`launch.extrapolate`'s docstring)."""
    cfg = tcfg.ARCHS[arch].reduced()
    names, _ = EX.group_counts(cfg)
    cfg = EX.with_counts(cfg, names, counts)
    mesh = SH.Mesh(("data", "model"), sizes)
    rec = EX.extrapolate_cell(arch, TRAIN_TINY, verbose=False, cfg=cfg,
                              device="cpu", mesh=mesh)
    full = DR.run_cell(arch, TRAIN_TINY, False, verbose=False, cfg=cfg,
                       mesh=mesh, device="cpu")
    assert rec["group_counts"] == counts
    for key in ("per_device_flops", "per_device_bytes",
                "collective_bytes_per_device", "collective_bytes_total",
                "compute_term_s", "memory_term_s"):
        assert rec[key] == full[key], key
    assert rec["collective_term_s"] == pytest.approx(
        full["collective_term_s"], rel=1e-12)


def test_run_cell_records_and_refusals(tmp_path):
    import torch.distributed as dist

    skip = DR.run_cell("internlm2-1.8b", "long_500k", False, verbose=False)
    assert skip["status"] == "SKIP" and skip["reason"]
    DR.fake_group(4)
    try:
        with pytest.raises(ValueError, match="process group exists"):
            DR.run_cell("internlm2-1.8b", TRAIN_TINY, False, cfg=_tiny_cfg(),
                        mesh=SH.Mesh(("data", "model"), (2, 2)))
    finally:
        dist.destroy_process_group()
    assert not dist.is_initialized()
    # the encoder-decoder's decode cell fails as the reference's does
    assert DR.main(["--arch", "seamless-m4t-large-v2", "--shape",
                    "decode_32k", "--out", str(tmp_path)]) == 1
    rec = json.loads((tmp_path / "seamless-m4t-large-v2_decode_32k_single"
                      ".json").read_text())
    assert rec["status"] == "FAIL" and "ring" in rec["error"]
    assert not dist.is_initialized()


def test_rates_are_the_h100s():
    assert (DR.PEAK_FLOPS, DR.HBM_BW, DR.LINK_BW, DR.NVLINK_BW) == (
        989e12, 3.35e12, 50e9, 450e9)
    assert DR.collective_bytes([("all-reduce", 8, (0, 1)),
                                ("all-gather", 4, (0, 16)),
                                ("all-reduce", 2, None)]) == {
        "all-reduce": 10, "all-gather": 4}
    assert DR.collective_seconds([("all-reduce", 450, (0, 7)),
                                  ("all-gather", 50, (0, 8))]) == \
        pytest.approx(1e-9 + 1e-9)
