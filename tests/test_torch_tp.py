"""The port's training step at a ``model`` axis above 1 (tensor and
expert parallelism by DTensor placement, ZeRO over ``data``) on gloo
ranks, against one rank.

`launch.train.make_step` at (dp, tp) = (1, 2) and (2, 2)
(`tests/_torch_mesh_worker.py: run_train_many`, one 2-rank and one
4-rank job, both at once) runs 3 steps of the reduced float32
internlm2-1.8b, gemma3-1b, deepseek-v3 (MLA and MoE, the expert stacks
over ``model``), mamba2-370m, zamba2-7b and seamless-m4t on the global
batch of B x S = 4 x 16, with the parameters, the optimizer state and
the batch placed by the reference's rules.  Against the same steps in
one process on plain tensors, by the measure and bounds of
`tests/test_torch_launch.py::test_two_ranks_equal_one_process` (W = 2):

* the losses within LOSS_TOL of the loss (the mean over the global
  batch: nothing is averaged twice);
* m and v within MOMENT_TOL of each leaf's largest |value|; params and
  master by the update each entry took (`_torch_port.update_errors`:
  STEP_TOL, GRAD_TOL, FLIP, FLIP_SHARE);
* the ZeRO-placed master on each rank is the shard the rules give it
  (`sharding.zero_spec` over ``data``, the parameter's spec over
  ``model``), and once gathered it is the state above;
* a checkpoint written at tp = 2 (every rank gathers, rank 0 writes)
  restores at tp = 1 to the gathered tree, bit for bit, and resumes.
"""
import functools
import tempfile
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_mesh_worker import spawn_mesh
from _torch_port import one_torch_thread  # noqa: F401 (fixture)
from _torch_port import update_errors

from repro_torch import optim
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_arch
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.distributed import sharding as SH
from repro_torch.launch import train as TR
from repro_torch.models import build, value_and_grad
from repro_torch.models.scan_util import tree_leaves

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ARCHS = ("internlm2-1.8b", "gemma3-1b", "deepseek-v3-671b", "mamba2-370m",
         "zamba2-7b", "seamless-m4t-large-v2")
MESHES = {"1x2": (1, 2), "2x2": (2, 2)}
SEED, BATCH, SEQ, STEPS = 4, 4, 16, 3
#: the loss against one rank's, relative (float32 sums in another order)
LOSS_TOL = 1e-6
#: test_torch_launch.py's bounds for W = 2 (see there)
MOMENT_TOL = 2e-5
STEP_TOL = 1e-3
GRAD_TOL = 2e-5
FLIP = 2.0
FLIP_SHARE = 1e-4


def _cfg(arch):
    import dataclasses

    return dataclasses.replace(get_arch(arch).reduced(), dtype="float32")


@functools.lru_cache(maxsize=None)
def _jobs():
    """Both meshes' rank results, the two jobs run at once; the (2, 2)
    job's first arch saves its final state under ``ckpt``."""
    root = Path(tempfile.mkdtemp(prefix="torch_tp_"))
    res, errs = {}, []

    def job(name):
        dp, tp = MESHES[name]
        case = {"archs": np.array(",".join(ARCHS)), "seed": np.array(SEED),
                "batch": np.array(BATCH), "seq": np.array(SEQ),
                "steps": np.array(STEPS), "compress": np.array(0),
                "tp": np.array(tp), "f32": np.array(1)}
        if name == "2x2":
            case["ckpt"] = np.array(str(root / "ckpt"))
        out = root / name
        out.mkdir()
        try:
            res[name] = spawn_mesh(dp * tp, case, out,
                                   body="run_train_many")
        except Exception as e:  # re-raised in the test
            errs.append(e)

    threads = [threading.Thread(target=job, args=(n,)) for n in MESHES]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errs:
        raise errs[0]
    return res, root


@functools.lru_cache(maxsize=None)
def _one_rank(arch):
    """STEPS steps on one process: (losses, params, state, the start's
    leaves, each step's gradient leaves, the summed learning rates)."""
    cfg = _cfg(arch)
    bundle = build(cfg)
    ocfg = optim.AdamWConfig(total_steps=10)
    params = bundle.init(SEED, device="cpu")
    start = tree_leaves(params)
    state = optim.init(params, ocfg)
    step = TR.make_step(bundle, ocfg, cfg, False, None)
    grad = value_and_grad(lambda p, b: bundle.loss_fn(p, b, remat=True)[0])
    data = SyntheticTokens(cfg.vocab, SEQ, BATCH, seed=SEED)
    args = type("A", (), {"batch": BATCH, "seq": SEQ})
    losses, grads, lrs = [], [], 0.0
    for s in range(STEPS):
        batch = {k: torch.from_numpy(v) for k, v in
                 TR._host_batch(data, cfg, args, s).items()}
        grads.append(tree_leaves(grad(params, batch)[1]))
        params, state, loss = step(params, state, batch)
        losses.append(float(loss))
        lrs += float(optim.cosine_lr(ocfg, s + 1))
    return losses, params, state, start, grads, lrs


def _leaves(res, prefix):
    n = len([k for k in res if k.startswith(prefix)
             and k[len(prefix):].isdigit()])
    return [torch.from_numpy(res[f"{prefix}{i}"]) for i in range(n)]


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_tp_equals_one_rank(arch, mesh_name):
    res = _jobs()[0][mesh_name]
    losses, params, state, start, grads, lrs = _one_rank(arch)
    for r in res[1:]:  # every rank gathers the same tree
        for k in res[0]:
            if k.startswith(arch + "/") and "_shard" not in k:
                assert np.array_equal(res[0][k], r[k]), k
    got = res[0]
    for s, want in enumerate(losses):
        assert abs(got[f"{arch}/losses"][s] - want) <= LOSS_TOL * abs(want)
    for name, tree in (("p", params), ("master", state.master)):
        worst, near, used, total = update_errors(
            _leaves(got, f"{arch}/{name}"), tree_leaves(tree), start, grads,
            GRAD_TOL, STEP_TOL)
        assert worst <= STEP_TOL, (name, worst)
        assert near <= FLIP * lrs, (name, near / lrs)
        assert used <= FLIP_SHARE * total, (name, used, total)
    for name, tree in (("m", state.m), ("v", state.v)):
        for k, (a, b) in enumerate(zip(_leaves(got, f"{arch}/{name}"),
                                       tree_leaves(tree))):
            bound = MOMENT_TOL * float(b.abs().max())
            assert float((a.double() - b.double()).abs().max()) <= bound, (
                name, k)


def _local_shape(spec, shape, mesh):
    out = []
    for entry, dim in zip(tuple(spec) + (None,) * len(shape), shape):
        axes = entry if isinstance(entry, tuple) else (
            () if entry is None else (entry,))
        n = 1
        for a in axes:
            n *= mesh.shape[a]
        out.append(-(-dim // n))
    return tuple(out)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_zero_state_is_sharded(mesh_name):
    """Rank 0's master shards are the rules' (param spec + ZeRO over
    ``data``), for every leaf of every architecture."""
    res = _jobs()[0][mesh_name][0]
    dp, tp = MESHES[mesh_name]
    mesh = SH.Mesh(("data", "model"), (dp, tp))
    sharded = 0
    for arch in ARCHS:
        params = build(_cfg(arch)).init(0, device="meta")
        want = []
        SH._tree_map_with_path(lambda p, t: want.append(_local_shape(
            SH.zero_spec(SH.param_spec(SH._path_str(p), tuple(t.shape),
                                       mesh), tuple(t.shape), mesh),
            tuple(t.shape), mesh)), params)
        got = [tuple(int(x) for x in res[f"{arch}/master_shard{i}"])
               for i in range(len(want))]
        assert got == want, arch
        sharded += sum(g != tuple(t.shape) for g, t in
                       zip(got, tree_leaves(params)))
    assert sharded  # the rules do shard


def test_tp2_checkpoint_resumes_at_tp1(tmp_path):
    """The (2, 2) job's final internlm2-1.8b state, written as the
    launcher writes it, restored into one process's plain tree: bit for
    bit the gathered tree; one more step from it runs."""
    res, root = _jobs()
    got = res["2x2"][0]
    arch = ARCHS[0]
    cfg = _cfg(arch)
    bundle = build(cfg)
    ocfg = optim.AdamWConfig(total_steps=10)
    like = bundle.init(0, device="cpu")
    mgr = CheckpointManager(str(root / "ckpt"))
    assert mgr.dir.exists()
    p = CheckpointManager(str(mgr.dir / "params")).restore(
        STEPS, like, device="cpu")
    st = CheckpointManager(str(mgr.dir / "opt")).restore(
        STEPS, optim.init(like, ocfg), device="cpu")
    for name, tree in (("p", p), ("master", st.master), ("m", st.m),
                       ("v", st.v)):
        for a, b in zip(_leaves(got, f"{arch}/{name}"), tree_leaves(tree)):
            assert a.dtype == b.dtype and torch.equal(a, b), name
    assert int(st.step) == STEPS
    batch = {k: torch.from_numpy(v) for k, v in SyntheticTokens(
        cfg.vocab, SEQ, BATCH, seed=SEED).batch(STEPS).items()}
    _, st2, loss = TR.make_step(bundle, ocfg, cfg, False, None)(p, st, batch)
    assert np.isfinite(float(loss)) and int(st2.step) == STEPS + 1
