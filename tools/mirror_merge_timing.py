"""Time the mirror merges of a hub-split graph at a benchmark cell's shapes.

    python3 tools/mirror_merge_timing.py [--workload kron23.mirror_stream]
        [--seed N] [--reps 5]

Builds the cell's split graph on the first CUDA device as the benchmark
builds it for the cell (`portbench/`: the configuration's graph,
relabelled and dealt into blocks by `--seed`, then
`hub_split.build_split_blocks`), then runs the mirror-aware coreness one
superstep at a time.  In every superstep the combine (`hindex_ell`) runs
twice: as a mirrored run launches it, with the row lengths of
`skip_group_rows` (0 on the live group rows), and over every row up to
`g.deg`; the first must give 0 on the group rows and the second's values
elsewhere.  The merge runs twice: through the kernel (`hindex_mirror`,
the `mirror_hindex` CUDA kernel) and through the plain version
(`hindex_mirror_plain`), both over the plan's `group_layout`; the two
must give the same integers, the same as the kernel over the full-row
partials, and the coreness at the fixpoint must equal
`coreness(mirror=)`'s.  Then it runs a mirrored `connected_components`
twice (the second run's seconds, supersteps and peak device memory; its
labels must be a fixpoint of one more merged superstep) and times one merge of each
combine through `ops._mirror_merge` (`merge_ms`, which `chip_smoke.py`
calls too): min over the labels, sum over random floats, the h-index over
the coreness, and the plain h-index beside the kernel.  Each time is the
median of `--reps` calls, with CUDA events.  Prints one JSON line: the
card, the sizes, each superstep's milliseconds (the kernel's launch, the
clone of the partials the wrapper makes, the plain merge, the combine
with the group rows skipped and over every row),
the groups that took a further window (`hindex_mirror.wide_groups`), the
h-index merge's least bytes a superstep and their time at the card's peak
bandwidth, the milliseconds to make the group layout, the run of
`connected_components` and the merges of every combine.
"""
import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

#: HBM bytes a second of one H100 SXM (the benchmark's `peaks.json`)
PEAK_BYTES_S = 3.35e12


def split_graph(workload: str, seed: int, device):
    """The cell's split graph and plan, as the benchmark builds them."""
    from portbench.harness import graphs, spec
    from repro_torch.core.hub_split import build_split_blocks

    cell = spec.load_cell(workload, ROOT)
    conf = cell.config
    gen = torch.Generator(device=device).manual_seed(seed)
    lay = graphs.make_layout(conf, gen, cell.root)
    real = torch.nonzero(lay.node_mask)[:, 0]
    assign = torch.empty(lay.n, dtype=torch.int64, device=device)
    assign[lay.orig_id[real]] = real // lay.Cn
    ends = lay.orig_id[torch.stack([lay.keys // lay.N, lay.keys % lay.N], 1)]
    return build_split_blocks(ends, lay.n, assign, lay.P,
                              int(conf["hub_threshold"]),
                              Cn=int(conf["node_capacity"]), device=device)


def timed(fn, reps: int):
    """(fn's last result, median device ms of `reps` calls)."""
    ms = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        b.synchronize()
        ms.append(a.elapsed_time(b))
    return out, statistics.median(ms)


def merge_ms(g2, plan, layout, fields, reps: int) -> dict:
    """Median device ms of one mirror merge per combine at this graph's
    shapes, through `ops._mirror_merge` over `layout` (the plan's
    `group_layout`), and of the plain h-index merge beside the kernel:
    ``{"min_ms", "sum_ms", "hindex_ms", "hindex_plain_ms"}``.  `fields`
    maps "min", "sum" and "hindex" to (partials, field)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.mirror_hindex import hindex_mirror_plain

    out = {}
    for c, (red, field) in fields.items():
        _, out[f"{c}_ms"] = timed(lambda: ops._mirror_merge(
            red, field, g2.nbr, plan, c, deg=g2.deg, layout=layout), reps)
    red, field = fields["hindex"]
    _, out["hindex_plain_ms"] = timed(lambda: hindex_mirror_plain(
        red, field, g2.nbr, plan, layout), reps)
    return out


def least_bytes(g2, plan) -> int:
    """What one merge must move at least: the group rows' valid slots,
    the distinct field values they name, each group row's length and id,
    each group's degree and place, and one value written a group row."""
    live = plan.grp_gid < plan.Gmax
    rows = plan.grp_rows[live].long()
    deg = g2.deg[rows].long()
    slots = int(deg.sum())
    nb = g2.nbr[rows]
    named = torch.unique(nb[nb >= 0]).numel()
    groups = int(torch.unique(plan.grp_gid[live]).numel())
    R = rows.numel()
    return 4 * slots + 4 * named + 4 * R * 3 + (4 + 16) * groups


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", default="kron23.mirror_stream")
    p.add_argument("--seed", type=int, default=2147800001)
    p.add_argument("--reps", type=int, default=5)
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core import connected_components, coreness
    from repro_torch.core.algorithms import CorenessBlockProgram
    from repro_torch.core.engine import BlockCtx
    from repro_torch.kernels import ops
    from repro_torch.kernels.ell_hindex import hindex_ell
    from repro_torch.kernels.mirror_hindex import (
        group_layout, hindex_mirror, hindex_mirror_plain, skip_group_rows)

    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    g2, plan = split_graph(a.workload, a.seed, dev)
    torch.cuda.synchronize()
    layout, layout_ms = timed(lambda: group_layout(plan), a.reps)
    lens = skip_group_rows(g2.deg, plan)
    live = plan.row_gid < plan.Gmax
    prog = CorenessBlockProgram()
    state = prog.mirror_state(prog.init(ops._mirror_init_view(g2, plan)),
                              plan.primary_row)
    ctx = BlockCtx(deg=plan.ldeg, node_mask=g2.node_mask,
                   n_real=plan.n_logical)
    steps, wide = [], []
    while True:
        field = prog.halo_field(state)
        red, combine_ms = timed(
            lambda: hindex_ell(g2.nbr, field, deg=lens), a.reps)
        full, combine_all_ms = timed(
            lambda: hindex_ell(g2.nbr, field, deg=g2.deg), a.reps)
        if not torch.equal(red, torch.where(live, 0, full)):
            raise AssertionError(f"superstep {len(steps)}: the combine "
                                 "with the group rows skipped differs")
        before = int(hindex_mirror.wide_groups)
        got = hindex_mirror(red, field, g2.nbr, g2.deg, plan, layout)
        torch.cuda.synchronize()
        wide.append(int(hindex_mirror.wide_groups) - before)
        _, kernel_ms = timed(lambda: hindex_mirror(
            red, field, g2.nbr, g2.deg, plan, layout), a.reps)
        _, clone_ms = timed(red.clone, a.reps)
        want, plain_ms = timed(lambda: hindex_mirror_plain(
            red, field, g2.nbr, plan, layout), a.reps)
        if not (torch.equal(got, want) and torch.equal(
                got, hindex_mirror(full, field, g2.nbr, g2.deg, plan,
                                   layout))):
            raise AssertionError(f"superstep {len(steps)}: the kernel and "
                                 "the plain merge differ")
        steps.append(dict(kernel_ms=kernel_ms, clone_ms=clone_ms,
                          plain_ms=plain_ms, combine_ms=combine_ms,
                          combine_all_ms=combine_all_ms))
        new = prog.update(ctx, state, got)
        changed = bool((new != state).any())
        state = new
        if not changed:
            break
    core = torch.where(g2.node_mask, state, 0)
    if not torch.equal(core, coreness(g2, mirror=plan)):
        raise AssertionError("the stepped coreness differs from coreness()")
    # a mirrored connected_components on the split graph, after a warm-up
    # run: its labels are a fixpoint of one more merged superstep
    connected_components(g2, mirror=plan)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    labels, cc_steps = connected_components(g2, mirror=plan, with_steps=True)
    torch.cuda.synchronize()
    cc_s = time.perf_counter() - t0
    cc_peak = torch.cuda.max_memory_allocated(dev)
    red = ops._mirror_merge(ops.neighbor_combine_blocks(g2, labels, "min"),
                            labels, g2.nbr, plan, "min", layout=layout)
    if not bool((torch.minimum(labels, red) == labels)[g2.node_mask].all()):
        raise AssertionError("the mirrored labels are not a fixpoint")
    floats = torch.rand(g2.N, device=dev)
    merges = merge_ms(g2, plan, layout, {
        "min": (labels, labels), "sum": (floats, floats),
        "hindex": (core, core)}, a.reps)
    nbytes = least_bytes(g2, plan)
    print(json.dumps(dict(
        workload=a.workload, seed=a.seed, card=card.strip(),
        torch=torch.__version__, N=g2.N, Cd=g2.Cd, Gmax=plan.Gmax,
        groups=plan.n_groups, group_rows=int((plan.grp_gid < plan.Gmax)
                                             .sum()),
        nbig=int(layout.nbig), supersteps=len(steps),
        kernel_ms_sum=sum(s["kernel_ms"] for s in steps),
        plain_ms_sum=sum(s["plain_ms"] for s in steps),
        clone_ms_sum=sum(s["clone_ms"] for s in steps),
        combine_ms_sum=sum(s["combine_ms"] for s in steps),
        combine_all_ms_sum=sum(s["combine_all_ms"] for s in steps),
        least_bytes=nbytes, bound_ms=nbytes / PEAK_BYTES_S * 1e3,
        wide_groups=wide, group_layout_ms=layout_ms,
        cc_seconds=cc_s, cc_supersteps=cc_steps, cc_peak_bytes=cc_peak,
        components=int(torch.unique(labels[plan.primary_mask]).numel()),
        merge_ms=merges, steps=steps)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
