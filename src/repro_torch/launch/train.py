"""Training launcher: mesh + model + data + optimizer + checkpointing +
fault handling, end to end (the JAX package's `launch.train`).

One process a rank.  Without a process group the launcher is one rank;
under an initialized `torch.distributed` default group of W ranks (a
caller's `init_process_group`, as the tests' gloo ranks do) each rank
holds the whole parameter tree (at ``model`` size 1 every parameter spec
is replicated), takes its slice of the global batch by
`sharding.batch_spec`, and the gradients are averaged with one
`all_reduce` a leaf, as the reference's jit over a dp-sharded batch
computes the global mean.  With ``--grad-compression`` the local
gradients go through `optim.compress.compressed_psum_mean` instead (the
int8 mean with error feedback) and the loss is averaged over the group;
with no group the launcher makes a one-rank group for it (NCCL on the
card, gloo on the CPU), as the reference's `shard_map` over a one-device
mesh.  A ``model`` axis above 1 raises NotImplementedError, so only
``--mesh test`` trains: ``single`` and ``multi`` are kept for the
reference's flags, and refuse a group smaller than their 256 or 512
ranks (ValueError) or, with enough ranks, their ``model`` axis of 16.

Runs on the current CUDA device unless ``--device cpu`` is given.

Examples
--------
  PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \
      --reduced --device cpu --steps 20 --batch 8 --seq 128 \
      --ckpt-dir ck --resume auto

Fault-tolerance drill (exits 42, restart resumes):
  ... --simulate-failure 7
"""
from __future__ import annotations

import argparse
import socket
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from .. import optim
from ..checkpoint import CheckpointManager, save_train_state
from ..configs import get_arch
from ..data.pipeline import SyntheticTokens
from ..device import resolve_device
from ..distributed import sharding as SH
from ..distributed.fault import (
    Heartbeat, StragglerMonitor, SimulatedFailure, RESTART_EXIT_CODE)
from ..models import build, value_and_grad
from ..models.layers import _dtype
from ..models.scan_util import tree_leaves
from .mesh import make_production_mesh, make_test_mesh


def _group_size() -> int:
    return dist.get_world_size() if dist.is_available() \
        and dist.is_initialized() else 1


def build_mesh(kind: str):
    """The `test` mesh over the ranks that exist (dp = ranks, tp = 1), or
    the production mesh, whose 256 (`single`) or 512 (`multi`) ranks must
    exist.  Only `test` trains: `make_step` refuses the production
    mesh's model axis."""
    if kind in ("single", "multi"):
        mesh = make_production_mesh(multi_pod=(kind == "multi"))
        if _group_size() < mesh.size:
            raise ValueError(
                f"--mesh {kind} needs {mesh.size} ranks "
                f"({dict(mesh.shape)}); the process group has "
                f"{_group_size()}")
        return mesh
    return make_test_mesh(dp=_group_size(), tp=1)


def _check_replicated(mesh) -> None:
    if mesh is not None and mesh.shape.get("model", 1) > 1:
        raise NotImplementedError(
            "the launcher keeps the whole parameter tree on every rank; a "
            f"model axis of {mesh.shape['model']} would shard the weights "
            "(tensor parallelism), which the port does not do")


def shard_batch(batch, mesh, rank: int):
    """This rank's rows of a global batch (a dict of arrays or tensors),
    by `sharding.batch_spec`: the leading dim split over the dp axes when
    it divides, else the whole batch on every rank."""
    if mesh is None:
        return batch
    n = SH.dp_size(mesh)
    B = len(next(iter(batch.values())))
    if n == 1 or SH.batch_spec(mesh, B, 1)[0] is None:
        return batch
    lo, hi = rank * B // n, (rank + 1) * B // n
    return {k: v[lo:hi] for k, v in batch.items()}


def make_step(bundle, ocfg, cfg, grad_compression: bool, mesh):
    """The training step.  Uncompressed: ``step(params, opt_state, batch)
    -> (params, opt_state, loss)``; with `grad_compression`:
    ``step(params, opt_state, ef, batch) -> (params, opt_state, ef,
    loss)``.  `batch` is this rank's slice (`shard_batch`).  Collectives
    run on the default process group when it holds more than one rank
    (always, with compression)."""
    _check_replicated(mesh)
    compute_dtype = _dtype(cfg.dtype)
    grad = value_and_grad(
        lambda p, batch: bundle.loss_fn(p, batch, remat=True)[0])

    if not grad_compression:
        def train_step(params, opt_state, batch):
            loss, grads = grad(params, batch)
            W = _group_size()
            if W > 1:
                for t in [loss] + tree_leaves(grads):
                    dist.all_reduce(t)
                    t.div_(W)
            new_params, new_state = optim.update(grads, opt_state, ocfg,
                                                 compute_dtype)
            return new_params, new_state, loss
        return train_step

    # int8-compressed DP gradient sync: per-rank grads + compressed mean
    # over the group, then the optimizer update.
    from ..optim.compress import compressed_psum_mean

    def train_step(params, opt_state, ef, batch):
        loss, g = grad(params, batch)
        dist.all_reduce(loss)
        loss = loss / _group_size()
        g, ef2 = compressed_psum_mean(g, ef)
        new_params, new_state = optim.update(g, opt_state, ocfg,
                                             compute_dtype)
        return new_params, new_state, ef2, loss

    return train_step


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _host_batch(data, cfg, args, step):
    """The global batch of `step` as numpy arrays, prefix and encoder
    inputs made as the reference makes them."""
    hostb = dict(data.batch(step))
    if cfg.n_prefix_tokens:
        hostb["prefix_embeds"] = np.zeros(
            (args.batch, cfg.n_prefix_tokens, cfg.prefix_dim), np.float32)
    if cfg.is_encdec:
        hostb["src_embeds"] = np.random.default_rng(step).normal(
            size=(args.batch, args.seq, cfg.d_model)
        ).astype(np.float32) * 0.1
    return hostb


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--mesh", default="test", choices=["test", "single", "multi"],
                    help="only `test` trains in the port; `single` and "
                    "`multi` (tensor parallel) are refused")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--resume", default=None, choices=[None, "auto"])
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--simulate-failure", type=int, default=None,
                    help="raise a simulated node failure at this step")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    own_group = args.grad_compression and not (
        dist.is_available() and dist.is_initialized())
    if own_group:  # the compressed mean runs over a group, here of one
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            init_method=f"tcp://127.0.0.1:{_free_port()}", world_size=1,
            rank=0)
    try:
        return _train(args, dev)
    finally:
        if own_group:
            dist.destroy_process_group()


def _train(args, dev) -> int:
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    mesh = build_mesh(args.mesh)
    rank = dist.get_rank() if _group_size() > 1 else 0
    bundle = build(cfg)
    ocfg = optim.AdamWConfig(total_steps=max(args.steps, 10))

    params = bundle.init(args.seed, device=dev)
    opt_state = optim.init(params, ocfg)

    data = SyntheticTokens(cfg.vocab, args.seq, args.batch, seed=args.seed)
    start_step = 0
    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    if mgr and args.resume == "auto":
        latest = CheckpointManager(str(mgr.dir / "params")).latest_step()
        if latest is not None:
            params = CheckpointManager(str(mgr.dir / "params")).restore(
                latest, params, device=dev)
            opt_state = CheckpointManager(str(mgr.dir / "opt")).restore(
                latest, opt_state, device=dev)
            start_step = latest
            print(f"[resume] restored step {latest}")
    saver = mgr if rank == 0 else None  # the replicas are equal

    ef = None
    if args.grad_compression:
        ef = optim.init_error_feedback(params)
    step_fn = make_step(bundle, ocfg, cfg, args.grad_compression, mesh)

    hb = Heartbeat(str(Path(tempfile.gettempdir())
                       / f"repro_torch_heartbeat_{args.arch}_{rank}.json"),
                   host=rank)
    strag = StragglerMonitor()

    t_start = time.time()
    for step in range(start_step, args.steps):
        hostb = shard_batch(_host_batch(data, cfg, args, step), mesh, rank)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in hostb.items()}
        t0 = time.time()
        try:
            if args.simulate_failure is not None and step == args.simulate_failure:
                raise SimulatedFailure(f"injected failure at step {step}")
            if args.grad_compression:
                params, opt_state, ef, loss = step_fn(params, opt_state, ef,
                                                      batch)
            else:
                params, opt_state, loss = step_fn(params, opt_state, batch)
            loss = float(loss)
        except SimulatedFailure as e:
            print(f"[fault] {e}; flushing checkpoint and exiting "
                  f"{RESTART_EXIT_CODE} for restart")
            if saver:
                save_train_state(saver, step, params, opt_state)
            sys.exit(RESTART_EXIT_CODE)
        dt = time.time() - t0
        hb.beat(step)
        if strag.observe(dt):
            print(f"[straggler] step {step} took {dt:.2f}s (>3x EWMA)")
        if step % args.log_every == 0:
            print(f"step {step:5d} loss {loss:8.4f} ({dt:.2f}s)")
        if not np.isfinite(loss):
            raise FloatingPointError(f"loss diverged at step {step}")
        if saver and (step + 1) % args.ckpt_every == 0:
            save_train_state(saver, step + 1, params, opt_state,
                             blocking=False)
    if saver:
        save_train_state(saver, args.steps, params, opt_state)
    print(f"done: {args.steps - start_step} steps in "
          f"{time.time() - t_start:.1f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
