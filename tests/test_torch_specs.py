"""PyTorch port vs the JAX package: the abstract cells
(`repro_torch.launch.specs` against `repro.launch.specs`), the training
cells here and the serving ones in `test_torch_specs_serve.py` (two
files, so that the suite's workers share them).

For every applicable (architecture × shape) cell of `SHAPES`
(`cell_applicable`), on the production mesh (16, 16) (the reference's on
a device-free `AbstractMesh`):

* `abstract_cell`'s inputs — params, optimizer state, batch, token,
  caches, position — leaf for leaf by path: the same shapes, dtypes and
  sharding specs, EQUAL; every leaf a `ShapeDtypeStruct`, nothing
  allocated (the inits ran on the meta device);
* the cell's step run on meta tensors of those inputs (the port's
  `jax.eval_shape`): every output a meta tensor, with the shapes and
  dtypes of the reference's `jax.eval_shape` of its step, EQUAL.

seamless-m4t's decode cell raises TypeError in both packages: the
encoder-decoder's `cache_init` takes no `ring`, which `abstract_caches`
passes.
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

import repro.configs as jcfg
from repro import optim as joptim
from repro.distributed import sharding as JSH
from repro.launch import specs as JSP

import repro_torch.configs as tcfg
from repro_torch import optim
from repro_torch.distributed import sharding as SH
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import make_production_mesh

CELLS = [(a, s.name) for a in sorted(jcfg.ARCHS) for s in jcfg.SHAPES
         if jcfg.cell_applicable(jcfg.ARCHS[a], s)[0]]
TRAIN_CELLS = [(a, s) for a, s in CELLS if s.startswith("train")]


def _dtype(d) -> str:
    if isinstance(d, torch.dtype):
        return str(d).removeprefix("torch.")
    return np.dtype(d).name


def _ref_leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {JSH._path_str(p): leaf for p, leaf in flat}


def _port_leaves(tree):
    out = {}
    SH._tree_map_with_path(
        lambda p, leaf: out.__setitem__(SH._path_str(p), leaf), tree)
    return out


def _ref_cell(arch, shape):
    return JSP.abstract_cell(
        jcfg.ARCHS[arch], jcfg.SHAPES_BY_NAME[shape],
        AbstractMesh((16, 16), ("data", "model")), joptim.AdamWConfig())


def _port_cell(arch, shape):
    return SP.abstract_cell(tcfg.ARCHS[arch], tcfg.SHAPES_BY_NAME[shape],
                            make_production_mesh(), optim.AdamWConfig())


def check_cell(arch, shape):
    """The cell's inputs and its step's outputs against the reference's
    (module docstring)."""
    if arch == "seamless-m4t-large-v2" and shape.startswith("decode"):
        for cell in (_ref_cell, _port_cell):
            with pytest.raises(TypeError, match="ring"):
                cell(arch, shape)
        return
    jstep, jkw, jdonate = _ref_cell(arch, shape)
    step, kw, donate = _port_cell(arch, shape)
    assert donate == jdonate
    rl, pl = _ref_leaves(jkw), _port_leaves(kw)
    assert sorted(pl) == sorted(rl)
    for path, r in rl.items():
        p = pl[path]
        assert isinstance(p, SP.ShapeDtypeStruct), path
        assert (p.shape, _dtype(p.dtype), tuple(p.sharding.spec)) == (
            tuple(r.shape), _dtype(r.dtype), tuple(r.sharding.spec)), path

    # the step on meta tensors against the reference's jax.eval_shape
    ref_out = jax.eval_shape(jstep, **jax.tree_util.tree_map(
        lambda s: jax.ShapeDtypeStruct(s.shape, s.dtype), jkw))
    made = []

    def spy(**inputs):
        out = step(**inputs)
        made.extend(_port_leaves(out).values())
        return out

    out = SP.eval_shape(spy, **kw)
    assert made and all(t.device.type == "meta" for t in made)
    ro, po = _ref_leaves(ref_out), _port_leaves(out)
    assert sorted(po) == sorted(ro)
    for path, r in ro.items():
        assert (po[path].shape, _dtype(po[path].dtype)) == (
            tuple(r.shape), _dtype(r.dtype)), path


@pytest.mark.parametrize("arch,shape", TRAIN_CELLS)
def test_abstract_cell_equal_reference(arch, shape):
    check_cell(arch, shape)
