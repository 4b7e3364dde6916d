"""Training launcher: mesh + model + data + optimizer + checkpointing +
fault handling, end to end (the JAX package's `launch.train`).

One process a rank.  Without a process group the launcher is one rank
and trains on plain tensors.  Under an initialized `torch.distributed`
default group of W ranks (a caller's `init_process_group`, as the tests'
gloo ranks do) the mesh is ``--mesh test``'s (W, 1), or the production
mesh of ``single`` (16 x 16) or ``multi`` (2 x 16 x 16) when 256 or 512
ranks exist, and the parameters, the optimizer state and the batch are
DTensors placed by the reference's rules (`distributed.sharding`):
weights over ``model`` (TP, and EP for the expert stacks), master, m
and v also over ``data`` (ZeRO), the batch over the data axes.  DTensor
propagates the shardings op by op as GSPMD does; the gradients leave the
backward as partial sums over the data axes, and `optim.update`
reduce-scatters them to the state's placement and all-gathers the new
parameters, so the step is the reference's jit over the global batch.

With ``--grad-compression`` the parameters stay whole on every rank,
as the reference's `shard_map` takes them (``P()``): each rank computes
the gradient of its data slice of the batch, and
`optim.compress.compressed_psum_mean` (the int8 mean with error
feedback) and the loss's mean run over the data axes only; with no
group the launcher makes a one-rank group for it (NCCL on the card,
gloo on the CPU), as the reference's `shard_map` over a one-device
mesh.

Checkpoints hold whole tensors: every rank takes part in
`sharding.gather`, then rank 0 writes; ``--resume auto`` reads the
whole tree on every rank and places it.

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
    exist."""
    if kind in ("single", "multi"):
        mesh = make_production_mesh(multi_pod=(kind == "multi"))
        if _group_size() < mesh.size:
            raise ValueError(
                f"--mesh {kind} needs {mesh.size} ranks "
                f"({dict(mesh.shape)}); the process group has "
                f"{_group_size()}")
        return mesh
    return make_test_mesh(dp=_group_size(), tp=1)


def shard_batch(batch, mesh, rank: int):
    """This rank's rows of a global batch (a dict of arrays or tensors),
    by `sharding.batch_spec`: the leading dim split over the dp axes when
    it divides, else the whole batch on every rank.  A rank's place on
    the dp axes is its rank over the ``model`` size (the mesh is laid
    out row-major, ``model`` minor)."""
    if mesh is None:
        return batch
    n = SH.dp_size(mesh)
    B = len(next(iter(batch.values())))
    if n == 1 or SH.batch_spec(mesh, B, 1)[0] is None:
        return batch
    i = rank // mesh.shape.get("model", 1)
    lo, hi = i * B // n, (i + 1) * B // n
    return {k: v[lo:hi] for k, v in batch.items()}


def place_state(params, opt_state, mesh, dmesh):
    """Whole params and optimizer state (the same on every rank) as
    DTensors on `dmesh`, placed by the reference's rules:
    `param_shardings` and the ZeRO `opt_shardings`."""
    return (SH.place(params, SH.param_shardings(params, mesh), dmesh),
            SH.place(opt_state, SH.opt_shardings(opt_state, params, mesh),
                     dmesh))


def place_batch(batch, mesh, dmesh):
    """A whole global batch (a dict of tensors, the same on every rank) as
    DTensors placed by `sharding.batch_spec`."""
    return SH.place(batch, {
        k: SH.batch_spec(mesh, v.shape[0], v.dim() - 1)
        for k, v in batch.items()}, dmesh)


def _dp_group(mesh, device):
    """The process group of the mesh's data axes: the default group when
    they span it, else this rank's data sub-group of a device mesh."""
    if mesh is None or SH.dp_size(mesh) == _group_size():
        return None
    sub = SH.device_mesh(mesh, device)[SH.dp_axes(mesh)]
    return (sub._flatten() if sub.ndim > 1 else sub).get_group()


def make_step(bundle, ocfg, cfg, grad_compression: bool, mesh):
    """The training step.  Uncompressed: ``step(params, opt_state, batch)
    -> (params, opt_state, loss)``; with `grad_compression`:
    ``step(params, opt_state, ef, batch) -> (params, opt_state, ef,
    loss)``.

    Uncompressed, the step takes plain tensors on one rank, or DTensors
    (`place_state`, `place_batch`: the global batch) on any group, and
    then runs in `sharding.step_context`; its loss is a plain scalar, the
    mean over the global batch.  Plain tensors under a group of more
    than one rank raise ValueError: the data-parallel mean comes from the
    placement, and nothing else averages the gradients.  Compressed, the
    step takes plain tensors and this rank's slice of the batch
    (`shard_batch`), and its collectives run over the mesh's data axes
    (the default group when they span it)."""
    compute_dtype = _dtype(cfg.dtype)
    grad = value_and_grad(
        lambda p, batch: bundle.loss_fn(p, batch, remat=True)[0])

    if not grad_compression:
        def train_step(params, opt_state, batch):
            if not SH.is_placed(params):
                if _group_size() > 1:
                    raise ValueError(
                        "plain parameters under a group of "
                        f"{_group_size()} ranks: place them "
                        "(launch.train.place_state, place_batch)")
                loss, grads = grad(params, batch)
                new_params, new_state = optim.update(grads, opt_state, ocfg,
                                                     compute_dtype)
                return new_params, new_state, loss
            with SH.step_context():
                loss, grads = grad(params, batch)
                new_params, new_state = optim.update(grads, opt_state, ocfg,
                                                     compute_dtype)
            return new_params, new_state, loss.full_tensor()
        return train_step

    # int8-compressed DP gradient sync: per-rank grads + compressed mean
    # over the data axes, then the optimizer update.
    from ..optim.compress import compressed_psum_mean

    groups = []

    def train_step(params, opt_state, ef, batch):
        if not groups:
            groups.append(_dp_group(mesh, tree_leaves(params)[0].device))
        group = groups[0]
        loss, g = grad(params, batch)
        dist.all_reduce(loss, group=group)
        loss = loss / dist.get_world_size(group)
        g, ef2 = compressed_psum_mean(g, ef, group=group)
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
                    help="`single` and `multi` need 256 and 512 ranks")
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
    placed = _group_size() > 1 and not args.grad_compression
    dmesh = SH.device_mesh(mesh, dev) if placed else None
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
    if placed:
        params, opt_state = place_state(params, opt_state, mesh, dmesh)
    saver = mgr if rank == 0 else None  # the checkpoint holds whole tensors

    def save(step, blocking=True):  # every rank gathers, rank 0 writes
        save_train_state(saver, step, params, opt_state, blocking=blocking)

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
        hostb = _host_batch(data, cfg, args, step)
        if not placed:
            hostb = shard_batch(hostb, mesh, rank)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in hostb.items()}
        if placed:
            batch = place_batch(batch, mesh, dmesh)
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
            if mgr:
                save(step)
            sys.exit(RESTART_EXIT_CODE)
        dt = time.time() - t0
        hb.beat(step)
        if strag.observe(dt):
            print(f"[straggler] step {step} took {dt:.2f}s (>3x EWMA)")
        if step % args.log_every == 0:
            print(f"step {step:5d} loss {loss:8.4f} ({dt:.2f}s)")
        if not np.isfinite(loss):
            raise FloatingPointError(f"loss diverged at step {step}")
        if mgr and (step + 1) % args.ckpt_every == 0:
            save(step + 1, blocking=False)
    if mgr:
        save(args.steps)
    print(f"done: {args.steps - start_step} steps in "
          f"{time.time() - t_start:.1f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
