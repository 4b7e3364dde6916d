"""The port's training launcher (`repro_torch.launch.train`) end to end on
the CPU.

* the fault drill through the CLI, the port's counterpart of the JAX
  package's `tests/test_system.py::test_train_launcher_with_failure_and_resume`:
  `--simulate-failure 6` exits 42 after saving step 6, `--resume auto`
  restores it, prints ``[resume] restored step 6``, exits 0, and its
  final checkpoint is bit-equal to an uninterrupted run's; `--mesh
  single` exits non-zero with the ValueError naming its 256 ranks;
  `--grad-compression` trains on a one-rank group the launcher makes;
* the meshes: `make_test_mesh` over the ranks that exist,
  `make_production_mesh`'s shapes, `build_mesh`, `make_step` on the
  production mesh's model axis;
* data parallelism on W = 2 gloo ranks (`tests/_torch_mesh_worker.py:
  run_train`): each rank's slice of the batch, the gradients averaged,
  two steps equal to one process's steps on the global batch (the
  bounds of `test_torch_train.py`: m and v against their values, params
  and master by the update they took, `_torch_port.update_errors`); with
  int8 compression, one step equal to a computation built from the
  reference's pieces: each rank's gradient on its slice, the JAX
  package's `quantize_int8` / `dequantize_int8` with error feedback, the
  mean, its `optim.update`.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_mesh_worker import spawn_mesh
from _torch_port import one_torch_thread  # noqa: F401 (fixture)
from _torch_port import update_errors

from repro import optim as joptim
from repro.optim.compress import dequantize_int8, quantize_int8

from repro_torch import optim
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_arch
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.launch import train as TR
from repro_torch.launch.mesh import make_production_mesh, make_test_mesh
from repro_torch.models import build, value_and_grad
from repro_torch.models.scan_util import tree_leaves, tree_map

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = Path(__file__).resolve().parents[1]
#: seconds a launcher subprocess may take (it takes a few)
CLI_TIMEOUT = 45
#: test_torch_train.py's bounds: m and v (sums of the gradients) relative
#: to the leaf's largest |value|; params and master by their update,
#: relative to the leaf's largest update, entries with a gradient within
#: GRAD_TOL of zero allowed FLIP times the summed learning rates, at most
#: FLIP_SHARE of them
MOMENT_TOL = 2e-5
STEP_TOL = 1e-3
GRAD_TOL = 2e-5
FLIP = 2.0
FLIP_SHARE = 1e-4


def _cli(tmp_path, *args):
    env = {"PYTHONPATH": str(REPO / "src"), "PATH": os.environ["PATH"],
           "HOME": str(tmp_path), "TMPDIR": str(tmp_path),
           "OMP_NUM_THREADS": "1"}
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train",
         "--arch", "internlm2-1.8b", "--reduced", "--device", "cpu",
         "--batch", "2", "--seq", "32", *args],
        capture_output=True, text=True, env=env, timeout=CLI_TIMEOUT)


def _restored(ck, step):
    """The params and opt sub-checkpoints at `step` as CPU tensors."""
    cfg = get_arch("internlm2-1.8b").reduced()
    params = build(cfg).init(0, device="cpu")
    state = optim.init(params, optim.AdamWConfig())
    return (CheckpointManager(str(ck / "params")).restore(step, params,
                                                          device="cpu"),
            CheckpointManager(str(ck / "opt")).restore(step, state,
                                                       device="cpu"))


def test_cli_fault_drill(tmp_path):
    drill = ["--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "3",
             "--steps", "9"]
    r1 = _cli(tmp_path, *drill, "--simulate-failure", "6")
    assert r1.returncode == 42, r1.stderr[-2000:]
    assert "[fault] injected failure at step 6" in r1.stdout
    r2 = _cli(tmp_path, *drill, "--resume", "auto")
    assert r2.returncode == 0, r2.stderr[-2000:]
    assert "[resume] restored step 6" in r2.stdout
    assert "done: 3 steps" in r2.stdout
    r3 = _cli(tmp_path, "--ckpt-dir", str(tmp_path / "ck_full"),
              "--ckpt-every", "3", "--steps", "9")
    assert r3.returncode == 0, r3.stderr[-2000:]
    assert r3.stdout.count("step ") == 9
    for a, b in zip(tree_leaves(_restored(tmp_path / "ck", 9)),
                    tree_leaves(_restored(tmp_path / "ck_full", 9))):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_cli_refuses_production_mesh(tmp_path):
    r = _cli(tmp_path, "--steps", "1", "--mesh", "single")
    assert r.returncode != 0
    assert "ValueError" in r.stderr and "256 ranks" in r.stderr


def test_cli_grad_compression_trains(tmp_path):
    r = _cli(tmp_path, "--steps", "3", "--grad-compression")
    assert r.returncode == 0, r.stderr[-2000:]
    assert "done: 3 steps" in r.stdout


def test_meshes():
    m = make_test_mesh()
    assert m.shape == {"data": 1, "model": 1} and m.axis_names == (
        "data", "model")
    assert TR.build_mesh("test") == m
    with pytest.raises(ValueError, match="2 ranks"):
        make_test_mesh(dp=2)
    p = make_production_mesh()
    assert p.shape == {"data": 16, "model": 16}
    mp = make_production_mesh(multi_pod=True)
    assert mp.axis_names == ("pod", "data", "model") and mp.size == 512
    with pytest.raises(ValueError, match="512 ranks"):
        TR.build_mesh("multi")
    cfg = get_arch("internlm2-1.8b").reduced()  # a model axis trains
    assert callable(TR.make_step(build(cfg), optim.AdamWConfig(), cfg,
                                 False, p))


def test_shard_batch():
    b = {"tokens": np.arange(12).reshape(6, 2)}
    mesh = TR.SH.Mesh(("data", "model"), (3, 1))
    assert [TR.shard_batch(b, mesh, r)["tokens"][:, 0].tolist()
            for r in range(3)] == [[0, 2], [4, 6], [8, 10]]
    odd = {"tokens": np.arange(10).reshape(5, 2)}  # 5 rows on 3 ranks
    assert TR.shard_batch(odd, mesh, 1)["tokens"] is odd["tokens"]


def _case(compress, steps):
    return {"arch": np.array("internlm2-1.8b"), "seed": np.array(4),
            "batch": np.array(4), "seq": np.array(16),
            "steps": np.array(steps), "compress": np.array(int(compress))}


def _leaves(res, name):
    return [torch.from_numpy(res[f"{name}{i}"])
            for i in range(len([k for k in res if k.startswith(name)
                                and k[len(name):].isdigit()]))]


def _close(got, want, tol):
    for k, (a, b) in enumerate(zip(got, want)):
        b = torch.as_tensor(np.array(b))
        bound = tol * float(b.abs().max())
        assert float((a.double() - b.double()).abs().max()) <= bound, k


def _updates_close(got, want, start, grads, lrs):
    """Params or master after len(grads) steps, by their update from
    `start` (the bounds above)."""
    worst, near_worst, used, total = update_errors(got, want, start, grads,
                                                   GRAD_TOL, STEP_TOL)
    assert worst <= STEP_TOL, worst
    assert near_worst <= FLIP * lrs, near_worst / lrs
    assert used <= FLIP_SHARE * total, (used, total)


def test_two_ranks_equal_one_process(tmp_path):
    """Two uncompressed steps on 2 gloo ranks, each on half the batch,
    against one process's steps on the global batch."""
    res = spawn_mesh(2, _case(False, 2), tmp_path, body="run_train")
    for name in ("p", "master", "m", "v"):
        for a, b in zip(_leaves(res[0], name), _leaves(res[1], name)):
            assert torch.equal(a, b)  # the replicas stay equal
    cfg = get_arch("internlm2-1.8b").reduced()
    bundle = build(cfg)
    ocfg = optim.AdamWConfig(total_steps=10)
    params = bundle.init(4, device="cpu")
    start = tree_leaves(params)
    state = optim.init(params, ocfg)
    step = TR.make_step(bundle, ocfg, cfg, False, None)
    grad = value_and_grad(lambda p, b: bundle.loss_fn(p, b, remat=True)[0])
    data = SyntheticTokens(cfg.vocab, 16, 4, seed=4)
    lrs, grads = 0.0, []
    for s in range(2):
        batch = {k: torch.from_numpy(v) for k, v in data.batch(s).items()}
        grads.append(tree_leaves(grad(params, batch)[1]))
        params, state, loss = step(params, state, batch)
        assert abs(float(loss) - res[0]["losses"][s]) <= 1e-6 * float(loss)
        lrs += float(optim.cosine_lr(ocfg, s + 1))
    _updates_close(_leaves(res[0], "p"), tree_leaves(params), start, grads,
                   lrs)
    _updates_close(_leaves(res[0], "master"), tree_leaves(state.master),
                   start, grads, lrs)
    _close(_leaves(res[0], "m"), tree_leaves(state.m), MOMENT_TOL)
    _close(_leaves(res[0], "v"), tree_leaves(state.v), MOMENT_TOL)


def test_two_ranks_compressed_equal_reference_pieces(tmp_path):
    """One int8-compressed step on 2 gloo ranks against: each rank's
    gradient on its half of the batch (the port's, computed here), the
    reference's quantizer with zero error feedback, the mean over the
    ranks, the reference's AdamW update."""
    res = spawn_mesh(2, _case(True, 1), tmp_path, body="run_train")
    cfg = get_arch("internlm2-1.8b").reduced()
    bundle = build(cfg)
    params = bundle.init(4, device="cpu")
    mesh = TR.SH.Mesh(("data", "model"), (2, 1))
    grad = value_and_grad(lambda p, b: bundle.loss_fn(p, b, remat=True)[0])
    batch = SyntheticTokens(cfg.vocab, 16, 4, seed=4).batch(0)
    deqs, efs, losses = [], [], []
    for r in range(2):
        local = {k: torch.from_numpy(v) for k, v in
                 TR.shard_batch(batch, mesh, r).items()}
        loss, g = grad(params, local)
        losses.append(float(loss))
        pair = [quantize_int8(jnp.asarray(x.numpy())) for x in tree_leaves(g)]
        deq = [dequantize_int8(q, s) for q, s in pair]
        deqs.append(deq)
        efs.append([np.asarray(x.numpy()) - np.asarray(d)
                    for x, d in zip(tree_leaves(g), deq)])
    mean = [(a + b) / 2 for a, b in zip(*deqs)]
    jparams = tree_map(lambda t: jnp.asarray(t.numpy()), params)
    jocfg = joptim.AdamWConfig(total_steps=10)
    it = iter(mean)
    jgrads = tree_map(lambda _: next(it), params)
    new_p, new_s = joptim.update(jgrads, joptim.init(jparams, jocfg), jocfg,
                                 jnp.float32)
    assert abs(res[0]["losses"][0] - sum(losses) / 2) <= 1e-6 * losses[0]

    def ordered(tree):  # the reference's leaves in the port's order
        return tree_leaves(tree_map(lambda _, j: j, params, tree))

    lr = float(optim.cosine_lr(optim.AdamWConfig(total_steps=10), 1))
    for r in range(2):
        _close(_leaves(res[r], "ef"), efs[r], 0.0)  # the same floats
        for name, tree in (("p", new_p), ("master", new_s.master)):
            _updates_close(_leaves(res[r], name), ordered(tree),
                           tree_leaves(params), [mean], lr)
        for name, tree in (("m", new_s.m), ("v", new_s.v)):
            _close(_leaves(res[r], name), ordered(tree), MOMENT_TOL)
