"""Rank body and launcher of the multi-process tests of the port's mesh
runtime (`repro_torch.runtime.spmd` under `torch.distributed`'s gloo
backend, on the CPU).

`spawn_mesh(W, case, out_dir, body)` starts W processes
(`torch.multiprocessing.spawn`), each joining a gloo group of W ranks on
a free localhost port with a 60 s collective timeout, and waits for them
with a time limit: a rank that fails or hangs ends the test instead of
hanging the suite.  Each rank runs `body` (the name of a function here:
`run_case`, the executor's primitives, or `run_programs`, the programs
and the mesh paths of maintenance, the stream and restore) on the graph
and inputs in `case` (a dict of numpy arrays), or `run_compress`, the
int8 compressed gradient mean, or `run_train` (`run_train_many`), the
training launcher's steps on a (dp, tp) mesh, or `run_cells`, the dry
run's counter on a real group, and writes its results to
``out_dir/rank{r}.npz``; `spawn_mesh` returns them, one dict per rank.

This module imports only torch, numpy and the port, so a rank starts in
a few seconds.
"""
from __future__ import annotations

import argparse
import socket
import time
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch

#: seconds a whole multi-process job may take before it is killed
JOB_TIMEOUT = 240


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_case(case: dict) -> dict:
    """Every executor primitive on `case`, under overlap True and False,
    then one incremental plan update and coreness again (in this rank's
    process group, or alone at W = 1)."""
    from repro_torch.core.graph import GraphBlocks
    from repro_torch.core.updates import apply_updates_host
    from repro_torch.kernels import ops
    from repro_torch.runtime.spmd import SpmdExecutor

    g = GraphBlocks.from_numpy(case, int(case["P"]), int(case["Cn"]),
                               int(case["Cd"]), device="cpu")
    t = {k: torch.from_numpy(case[k]) for k in
         ("est", "f", "elig", "vis", "core", "roots", "ks", "est0", "cand")}
    out = {}
    for ov in (True, False):
        ex = SpmdExecutor(g, overlap=ov)
        p = f"ov{int(ov)}_"
        out[p + "W"] = np.asarray(ex.wm.W)
        core, steps = ex.coreness()
        out[p + "core"] = core.numpy()
        out[p + "core_steps"] = np.asarray(steps)
        out[p + "hindex"] = ex.hindex(t["est"]).numpy()
        out[p + "frontier"] = ex.frontier(t["f"], t["elig"], t["vis"]).numpy()
        out[p + "frontier_shared"] = ops.frontier_blocks(
            g, t["f"], t["elig"][:, 0].contiguous(), t["vis"],
            backend="ell_spmd", executor=ex).numpy()
        vis, steps = ex.k_reachable_batch(t["core"], t["roots"], t["ks"])
        out[p + "reach"], out[p + "reach_steps"] = vis.numpy(), np.asarray(
            steps)
        est, steps = ex.restricted_recompute(t["est0"], t["cand"])
        out[p + "rec"], out[p + "rec_steps"] = est.numpy(), np.asarray(steps)
    window = [tuple(int(x) for x in e) for e in case["window"]]
    g2 = apply_updates_host(g.clone(), window)
    ex.apply_updates(g2, window)
    core, steps = ex.coreness()
    out["updated_core"], out["updated_steps"] = core.numpy(), np.asarray(
        steps)
    out["plan_updates"] = np.asarray(ex.plan_updates)
    out["spmd_core"] = ops.coreness_blocks(g2, backend="ell_spmd").numpy()
    return out


def stats_array(stats) -> np.ndarray:
    """A `StreamStats` / `BatchMaintenanceStats` as one int64 vector (the
    per-block tuple flattened in place)."""
    out = []
    for f in stats:
        out.extend(f if isinstance(f, tuple) else (f,))
    return np.asarray(out, np.int64)


def run_programs(case: dict) -> dict:
    """The mesh programs and the mesh paths of maintenance, the stream and
    restore, on `case`'s graph, through this rank's process group (or
    alone at W = 1): CC, PageRank (with a tolerance and 30 fixed
    supersteps), triangles and `fused_analytics` through one executor,
    `coreness_via_spmd` with its traces, mirrored coreness, CC, PageRank
    and triangles on the graph split at `case["threshold"]`,
    `maintain_batch`, and a windowed `StreamSession` whose snapshot after
    `case["restore_at"]` windows is restored and streamed on."""
    from repro_torch.checkpoint import (
        CheckpointManager, restore_session, save_session)
    from repro_torch.core import (
        connected_components, coreness, coreness_via_spmd, fused_analytics,
        maintain_batch, pagerank, split_hubs, triangle_counts)
    from repro_torch.core.graph import GraphBlocks
    from repro_torch.runtime.spmd import SpmdExecutor
    from repro_torch.runtime.stream import StreamSession

    import torch.distributed as dist

    sp = "ell_spmd"
    g = GraphBlocks.from_numpy(case, int(case["P"]), int(case["Cn"]),
                               int(case["Cd"]), device="cpu")
    core0 = torch.from_numpy(np.array(case["core"]))
    ups = [tuple(int(x) for x in e) for e in case["ups"]]
    out = {}
    ex = SpmdExecutor(g)
    out["W"] = np.asarray(ex.wm.W)
    for name, (val, steps) in {
            "cc": connected_components(g, backend=sp, executor=ex,
                                       with_steps=True),
            "pr": pagerank(g, backend=sp, executor=ex, with_steps=True),
            "pr30": pagerank(g, tol=None, max_steps=30, backend=sp,
                             executor=ex, with_steps=True),
            "tri": triangle_counts(g, backend=sp, executor=ex,
                                   with_steps=True)}.items():
        out[name], out[name + "_steps"] = val.numpy(), np.asarray(steps)
    (fc, fl, fr), n = fused_analytics(g, steps=int(case["pr_steps"]),
                                      backend=sp, executor=ex,
                                      with_steps=True)
    out.update(fused_core=fc.numpy(), fused_labels=fl.numpy(),
               fused_rank=fr.numpy(), fused_steps=np.asarray(n))
    out["plan_builds"] = np.asarray(ex.plan_updates + ex.full_rebuilds)
    core, eng = coreness_via_spmd(g)
    out["via_spmd"] = core.numpy()
    out["via_spmd_traces"] = np.asarray(len(eng.traces))
    out["via_spmd_totals"] = np.asarray(tuple(eng.message_totals()))

    gs = GraphBlocks.from_numpy({k[2:]: case[k] for k in case
                                 if k.startswith("s_")},
                                int(case["P"]), int(case["s_Cn"]),
                                int(case["s_Cd"]), device="cpu")
    g2, plan = split_hubs(gs, int(case["threshold"]))
    ex2 = SpmdExecutor(g2)
    out["m_core"] = coreness(g2, backend=sp, executor=ex2,
                             mirror=plan).numpy()
    out["m_cc"] = connected_components(g2, backend=sp, executor=ex2,
                                       mirror=plan).numpy()
    out["m_pr"] = pagerank(g2, tol=None, max_steps=int(case["pr_steps"]),
                           backend=sp, executor=ex2, mirror=plan).numpy()
    out["m_tri"] = triangle_counts(g2, backend=sp, mirror=plan).numpy()

    g3, core3, st = maintain_batch(g.clone(), core0.clone(), ups, R=4,
                                   backend=sp)
    out.update(mb_core=core3.numpy(), mb_nbr=g3.nbr.numpy(),
               mb_stats=stats_array(st))

    labels0 = torch.from_numpy(np.array(case["labels"]))
    ws = [ups[i:i + 4] for i in range(0, len(ups), 4)]
    sess = StreamSession(g.clone(), core0.clone(), R=4, backend=sp,
                         cc_labels=labels0.clone())
    at = int(case["restore_at"])
    for w in ws[:at]:
        sess.apply_window(w)
    rank = dist.get_rank() if dist.is_initialized() else 0
    mgr = CheckpointManager(str(Path(case["out_dir"].item())
                                / f"ckpt_rank{rank}"))
    save_session(mgr, sess)
    _, back, _ = restore_session(mgr, backend=sp, device="cpu")
    for w in ws[at:]:
        back.apply_window(w)
        sess.apply_window(w)
    for p, s in (("st_", sess), ("rs_", back)):
        out.update({p + "core": s.core.numpy(), p + "labels": s.labels.numpy(),
                    p + "nbr": s.g.nbr.numpy(),
                    p + "stats": stats_array(s.stats())})
    return out


def run_compress(case: dict) -> dict:
    """`optim.compressed_psum_mean` over this rank's process group: the
    tree ``{"x": g{rank}_x, "y": [g{rank}_y]}`` with error feedback
    ``e{rank}_*``, and the reference test's ``same`` gradient (equal on
    every rank) with zero error feedback."""
    import torch.distributed as dist

    from repro_torch.optim import compressed_psum_mean, init_error_feedback

    r = dist.get_rank()
    t = {k: torch.from_numpy(np.array(v)) for k, v in case.items()}
    grads = {"x": t[f"g{r}_x"], "y": [t[f"g{r}_y"]]}
    ef = {"x": t[f"e{r}_x"], "y": [t[f"e{r}_y"]]}
    red, ef2 = compressed_psum_mean(grads, ef)
    same = {"w": t["same"]}
    red_s, ef_s = compressed_psum_mean(same, init_error_feedback(same))
    return {"red_x": red["x"].numpy(), "red_y": red["y"][0].numpy(),
            "ef_x": ef2["x"].numpy(), "ef_y": ef2["y"][0].numpy(),
            "red_same": red_s["w"].numpy(), "ef_same": ef_s["w"].numpy()}


def run_train(case: dict) -> dict:
    """`steps` steps of the launcher's `make_step` on this rank's group,
    from the reduced `arch`'s init at `seed` (the same on every rank; in
    float32 when `f32`), on a (W / `tp`, `tp`) mesh: uncompressed, the
    params, state and global `SyntheticTokens` batches placed as
    DTensors (`place_state`, `place_batch`); with int8 gradient
    compression (`compress`), plain params and this rank's slice of the
    batch (`shard_batch`).  With `ckpt`, the final state is saved under
    ``<ckpt>/`` as the launcher saves it (every rank gathers, rank 0
    writes).  Returns the losses and the whole leaves of params, master,
    m, v (and the error feedback) as ``p{i}``, ``master{i}``, ``m{i}``,
    ``v{i}``, ``ef{i}``, and the local shard shapes of master as
    ``master_shard{i}``."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch import optim
    from repro_torch.checkpoint import CheckpointManager, save_train_state
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.train import (
        _host_batch, make_step, place_batch, place_state, shard_batch)
    from repro_torch.models import build
    from repro_torch.models.scan_util import tree_leaves

    cfg = get_arch(str(case["arch"])).reduced()
    if int(case.get("f32", 0)):
        cfg = dataclasses.replace(cfg, dtype="float32")
    bundle = build(cfg)
    params = bundle.init(int(case["seed"]), device="cpu")
    ocfg = optim.AdamWConfig(total_steps=10)
    state = optim.init(params, ocfg)
    compress = bool(case["compress"])
    ef = optim.init_error_feedback(params) if compress else None
    tp = int(case.get("tp", 1))
    W, rank = dist.get_world_size(), dist.get_rank()
    mesh = make_test_mesh(dp=W // tp, tp=tp)
    dmesh = None
    if not compress:
        dmesh = SH.device_mesh(mesh, "cpu")
        params, state = place_state(params, state, mesh, dmesh)
    step = make_step(bundle, ocfg, cfg, compress, mesh)
    B, S = int(case["batch"]), int(case["seq"])
    data = SyntheticTokens(cfg.vocab, S, B, seed=int(case["seed"]))
    args = argparse.Namespace(batch=B, seq=S)
    losses = []
    for s in range(int(case["steps"])):
        host = _host_batch(data, cfg, args, s)
        if compress:
            host = shard_batch(host, mesh, rank)
        batch = {k: torch.from_numpy(v) for k, v in host.items()}
        if compress:
            params, state, ef, loss = step(params, state, ef, batch)
        else:
            params, state, loss = step(params, state, place_batch(
                batch, mesh, dmesh))
        losses.append(float(loss))
    out = {"losses": np.array(losses)}
    for i, t in enumerate(tree_leaves(state.master)):
        out[f"master_shard{i}"] = np.array(
            t.to_local().shape if dmesh is not None else t.shape)
    if "ckpt" in case:
        save_train_state(CheckpointManager(str(case["ckpt"]))
                         if rank == 0 else None, int(case["steps"]),
                         params, state)
    params, state = SH.gather(params), SH.gather(state)
    for name, tree in (("p", params), ("master", state.master),
                       ("m", state.m), ("v", state.v), ("ef", ef)):
        for i, t in enumerate(tree_leaves(tree) if tree is not None else []):
            out[f"{name}{i}"] = t.numpy()
    return out


def run_train_many(case: dict) -> dict:
    """`run_train` for each of the comma-separated `archs` in turn, its
    results' keys prefixed ``{arch}/``; `ckpt` goes to the first."""
    out = {}
    for i, arch in enumerate(str(case["archs"]).split(",")):
        sub = {k: v for k, v in case.items()
               if k not in ("archs", "ckpt") or (k == "ckpt" and i == 0)}
        sub["arch"] = np.array(arch)
        for k, v in run_train(sub).items():
            out[f"{arch}/{k}"] = v
    return out


def run_cells(case: dict) -> dict:
    """The dry run's counter (`launch.dryrun.count_step`) on this rank of
    a real (2, 2) group, on the reduced float32 `arch` from `seed`: one
    training step on a `train` = (S, B) batch, one decode step at
    position 0 into fresh `decode` = (S, B) caches (each input placed as
    `specs.abstract_cell` places it), and, for the values, a 20-token
    prompt and one token decoded at position 20.  Returns each count
    (``{kind}_flops``, ``{kind}_bytes``, ``{kind}_kinds`` as JSON), the
    decode's logits and the first block's written K cache, whole."""
    import dataclasses
    import json

    import torch.distributed as dist

    from repro_torch import optim
    from repro_torch.configs import get_arch
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch import specs as SP
    from repro_torch.launch.train import place_batch, place_state
    from repro_torch.models import build

    cfg = dataclasses.replace(get_arch(str(case["arch"])).reduced(),
                              dtype="float32")
    b = build(cfg)
    seed = int(case["seed"])
    mesh = SH.Mesh(("data", "model"), (2, 2))
    dmesh = SH.device_mesh(mesh, "cpu")
    ocfg = optim.AdamWConfig()
    out = {}

    def record(kind, counter):
        out[kind + "_flops"] = np.asarray(counter.flops)
        out[kind + "_bytes"] = np.asarray(counter.bytes)
        out[kind + "_kinds"] = np.asarray(json.dumps(
            DR.collective_bytes(counter.collectives)))

    params = b.init(seed, device="cpu")
    S, B = (int(x) for x in case["train"])
    g = torch.Generator().manual_seed(seed)
    batch = {k: torch.randint(0, cfg.vocab, (B, S), generator=g,
                              dtype=torch.int32) for k in ("tokens", "labels")}
    p, st = place_state(params, optim.init(params, ocfg), mesh, dmesh)
    record("train", DR.count_step(SP.make_train_step(cfg, ocfg), dict(
        params=p, opt_state=st, batch=place_batch(batch, mesh, dmesh))))

    S, B = (int(x) for x in case["decode"])
    p = SH.place(params, SH.param_shardings(params, mesh), dmesh)

    def caches():
        c = b.cache_init(B, S, device="cpu")
        return SH.place(c, SH.cache_shardings(c, mesh), dmesh)

    def tokens(t):
        return place_batch({"t": t}, mesh, dmesh)["t"]

    serve = SP.make_serve_step(cfg)
    token0 = torch.zeros((B, 1), dtype=torch.int32)
    record("decode", DR.count_step(serve, dict(
        params=p, token=tokens(token0), caches=caches(), pos=0)))

    g = torch.Generator().manual_seed(seed)
    prompt = torch.randint(0, cfg.vocab, (B, 20), generator=g)
    token = torch.randint(0, cfg.vocab, (B, 1), generator=g)
    c = caches()
    _, c = serve(p, tokens(prompt), c, 0)
    logits, c = serve(p, tokens(token), c, 20)
    out["decode_logits"] = logits.full_tensor().numpy()
    out["decode_k0"] = c[0]["k"].full_tensor().numpy()
    assert dist.get_world_size() == 4
    return out


def _rank(rank: int, W: int, port: int, case_path: str, out_dir: str,
          body: str = "run_case"):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=W,
        rank=rank, timeout=timedelta(seconds=60))
    try:
        with np.load(case_path) as z:
            case = dict(z)
        out = globals()[body](case)
        np.savez(Path(out_dir) / f"rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


def spawn_mesh(W: int, case: dict, out_dir: Path,
               timeout: float = JOB_TIMEOUT, body: str = "run_case") -> list:
    """Run `body` (`run_case`, `run_programs`, `run_compress` or
    `run_train`) on W gloo ranks; returns each rank's result dict.  Raises if a rank fails or the job outlives
    `timeout` seconds (its processes are then killed)."""
    import torch.multiprocessing as mp

    out_dir = Path(out_dir)
    case_path = out_dir / "case.npz"
    np.savez(case_path, **case)
    ctx = mp.spawn(_rank, args=(W, _free_port(), str(case_path),
                                str(out_dir), body),
                   nprocs=W, join=False)
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"the {W}-rank gloo job outlived {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(5)
    res = []
    for r in range(W):
        with np.load(out_dir / f"rank{r}.npz") as z:
            res.append(dict(z))
    return res
