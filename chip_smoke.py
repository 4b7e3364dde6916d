#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

Run from the root of a checkout, on a machine with one CUDA card and nvcc:

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero):

1. card: the `nvidia-smi` name and power limit; build every CUDA
   kernels from `src/repro_torch/kernels/csrc` (one nvcc per source, in
   parallel).
2. kernel parity: each ELL kernel against its plain PyTorch version on
   the card, on the DS1 graph's adjacency and on its rows shuffled, at
   K = Cd and at the degree bound — `ell_hindex` and its "count" variant
   `ell_hindex_count` (also equal to the "sort" kernel) with est =
   degrees, random ints and the coreness, "sort" with the row lengths
   `deg` and without; `ell_frontier` at R = 1, 8, 13 on random masks and
   on the main path's first-hop masks (most rows need a column and miss),
   with `deg` and without, and with a frontier not 8-byte aligned; both
   redesigned kernels also on a hand-made graph (`_edge_rows`: empty,
   full, 31/32/33/64/65/256/257-slot rows, some longer than the h-index's
   register paths);
   `ell_allpairs` (the "allpairs" triangle variant, also equal to the
   "merge" kernel); `ell_cc` with random ints and CC labels;
   `ell_pagerank` with PageRank contributions and random floats, its sum
   bit-equal with `deg` and without; `ell_multi` with ("hindex", "min",
   "sum"), each alone and ("sum", "hindex"), every output bit-equal to
   its standalone kernel with the same `deg` and without, and
   `ell_triangles` with rows = nbr, a copy of nbr and a duplicate-id
   field; all four with the row lengths `deg` and without, on DS1
   (sorted, shuffled, and with holes: a PAD inside the `deg` prefix of
   every 7th row; K = Cd and the degree bound) and on the hand-made graph
   (the triangles' full 300-slot rows fill more than one of a warp's hash
   tables), the sum also on order-exposing floats (1e8 beside 1.0, -0.0),
   bit for bit against `ell_pagerank`.
   Bit-equal, except the float sum: allclose(rtol=1e-5, atol=1e-9)
   against `torch.sum`'s order.  Then `cc_union` (`cc_union_phase`, the
   union-find labels, which stands for no TPU kernel) against its plain
   version and `connected_components`, each case launched 20 times (the
   order of its atomics varies): DS1 sorted, shuffled and with holes, and
   the undirected closure of the hand-made graph (rows of 200 to 400
   slots: the warp's loop), shuffled and with holes; then its device µs
   on DS1 beside the plain version's and a superstep's least bytes.
3. dense parity: the two dense kernels against their plain versions on
   DS1's (50,048 x 50,048) bfloat16 adjacency (5.01 GB; row offsets past
   2^31) — `kcore_hindex` with est = degrees, random ints and the
   coreness at K = 128 and 150, `frontier` at R = 1, 8, 13 with
   per-column eligibility folded into `visited` (also equal to the ELL
   hop) and with a shared one.  Bit-equal.
4. main path at the paper's DS1 size (`snap_like("DS1", 1.0, seed=7)`,
   BFS-partitioned into 8 blocks): static coreness and a 200-update
   `run_stream` (R = 8) through the kernels, held against the plain
   backend (same coreness, same superstep counts, same `StreamStats`) and
   a fresh recompute; both kernels' launch counts must be > 0.  Then the
   same with `backend="dense"` (`main_path_ds1_dense`), held against the
   plain run; `kcore_hindex` and `frontier` must launch.
5. analytics_ds1, the BlockProgram path on the same graph, through the
   kernels and held against the plain backend: connected components,
   PageRank (30 fixed supersteps; and tol = 1e-6), triangle counts, the
   coreness program, `fused_analytics` warm-started from them, and the
   same 200-update stream with CC labels maintained; CC and triangles
   also against scipy on the host.  All six ELL kernels must launch.
   Then CC, both PageRanks, triangles and the coreness program with
   `backend="dense"` (`analytics_ds1_dense`), held against the plain run.
6. variants_ds1: `coreness_blocks(variant="count")` equal to the "sort"
   coreness in the same supersteps, and `neighbor_common_ell(variant=
   "allpairs")` equal to "merge" and to scipy's per-node triangles.
7. elastic_ds1: the elastic stream on DS1, through the kernels and the
   plain versions (`ell`, `torch`): a `StreamSession` with CC labels, the
   §4.2 rebalance (threshold 1.2, at most 8 moves a round) and
   `auto_grow`; the 100 inserts of the DS1 stream; `add_vertices` of two
   more vertices than the block with the fewest free rows holds (a Cn grow
   to 8,192, N = 65,536); a window joining the new vertices to the graph
   through their handles; `grow(Cd=256)`; `save_session` (async) and
   `restore_session` through a `CheckpointManager` in a temporary
   directory; the 100 deletes, in open-time ids, on the restored session.
   Both runs equal (core, labels, graph arrays, `StreamStats`), with
   migrations and two grows; coreness by `orig_id` and the edge set in
   original ids equal to a run of the same steps without rebalancing or
   checkpoint; core and labels equal a fresh recompute; `ell_hindex`,
   `ell_frontier` and `ell_cc` equal to their plain versions on the grown
   graph.  `ell_hindex`, `ell_frontier` and `ell_cc` must launch.  Prints
   the host seconds of every move selection, migration and grow, of the
   save and the restore, and the snapshot's bytes.
8. mesh_ds1: the mesh runtime (`runtime/spmd.py`) at W = 1 under a
   one-rank NCCL process group (warmed by one `all_reduce` first), so the
   halo exchange and the convergence flag go through the real
   `all_to_all_single` and `all_reduce`: `coreness_blocks`,
   `hindex_blocks` and an R = 8 `frontier_blocks` with
   ``backend="ell_spmd"``, then `k_reachable_batch` and the clamped
   recompute of the stream's first window, through one `SpmdExecutor`,
   equal to the single-device "ell" results and superstep counts;
   `ell_hindex` and `ell_frontier` against their plain versions on the
   executor's field (shard + halo buffer); the plan maintained through
   the 25 windows equal to a rebuild, and coreness after them equal to
   "ell".  Prints `build_halo_plan` host seconds, `apply_updates` host ms
   a window beside `rebuild`, ms a superstep (host clock over whole
   fixpoints, and one superstep's device work by CUDA events) beside the
   single-device loop, and the two kernels' launches (both must launch).
   Then mesh_programs_ds1, under the same group: the mesh programs
   (`SpmdEngine`) through ONE `SpmdExecutor` — CC, PageRank (30 fixed
   supersteps; tol = 1e-6), triangles, `fused_analytics` warm-started
   from the coreness and labels, `coreness_via_spmd` (its W2W totals
   equal `coreness_via_engine`'s metering) — the 200 DS1 updates through
   a `StreamSession(backend="ell_spmd")` with CC labels, its snapshot after
   window 12 restored by `restore_session(backend="ell_spmd")` and
   streamed on, and mirrored coreness on skew_egofb's split graph; each
   equal to the single-device "ell" run (integers, counts, graph arrays,
   `StreamStats` but the plan counters; ranks at RANK_TOL), the restored
   stream to the uninterrupted one in every field.  `ell_hindex`,
   `ell_frontier`, `ell_cc`, `ell_pagerank`, `ell_multi` and
   `ell_triangles` must launch, and the four combine kernels equal their
   plain versions on the executor's field (the triangles' a field of
   global-id rows).  Prints host ms a superstep (CC, mirrored coreness)
   and a window (the stream) beside "ell".
9. recovery_ds1: crash recovery (`runtime/recovery.py`) over the 200 DS1
   updates in 25 windows of R = 8 on "ell": an `ElasticCoordinator`
   checkpoints before window 10; before window 18 block 3 is lost (one
   block per worker, W_old = P): the live session is killed (a read of it
   must raise), the snapshot restored, block 3 evacuated (a Cn grow to
   8,192 first) and the 8 windows of the log tail replayed; the stream
   goes on.  The result equals a never-crashed run by original ids
   (coreness and edges) and a fresh recompute, and the same drill on
   "torch" (graph, coreness, `StreamStats`).  Prints the host seconds of
   the restore, the evacuation and the replay; `ell_hindex` and
   `ell_frontier` must launch.  The kernel line gives each of the six
   kernels the mesh runs its launches on `main_path_ds1`, `mesh_ds1`,
   `mesh_programs_ds1` and `recovery_ds1` (`launches_by_path`).
10. service_ds1: the query service (`repro_torch.service`) over the DS1
   stream, with the settings of the JAX package's
   `benchmarks/bench_service.py`: the 200 DS1 updates with inserts and
   deletes in turns (25 windows of R = 8, each with both ops),
   `ServiceConfig(max_queue=4096, max_batch=64, refresh_every=1,
   pr_steps=10)`, 48 queries submitted before each window, ids drawn from
   [0, N) by a seeded numpy generator, for the bench's three mixes
   (`gather`: core/degree; `mixed`: all five kinds, top-k at k = 8;
   `topk`: k in 1..16).  Each mix runs `QueryServer.serve` twice on fresh
   copies through the kernels and reports the second pass: p50/p99
   answer latency, qps of busy time, answered, shed (must be 0),
   batches, staleness, refreshes and their mean host seconds, the path's
   seconds and the launches of `ell_multi`, `ell_hindex`, `ell_frontier`
   and `cc_union` (each must launch).  Every published snapshot equals, bit
   for bit, a recompute on its epoch's graph (`coreness`,
   `connected_components`, `pagerank(tol=None, max_steps=10)` on "ell"),
   and every answer equals that recompute's (top-k in `jax.lax.top_k`'s
   order, ranks bit for bit); the `mixed` mix also runs once on the
   plain backend, whose answers must equal (ranks allclose at RANK_TOL,
   top-k ids equal up to ties within it); `compute_degrees(g)` equals
   `g.deg` on the card.
11. skew_egofb: hub mirroring (`core.hub_split`) on the JAX package's
   `benchmarks/bench_skew.py` graph at the paper's full ego-Facebook size
   (`snap_like("ego-Facebook", 1.0, seed=0)`: 4,039 nodes, 86,121 edges,
   max degree 1,279; `node_random_partition(n, 8, seed=0)`, one padding
   row per replica: N = 9,664, Cd = 1,287), split at threshold 64 (Cd =
   64); `mirror_report`'s counters must equal the JAX package's.  Static:
   coreness, CC, PageRank (30 steps), triangles and `fused_analytics`
   with `mirror=plan` on "ell" and "torch" (bit-equal integers, ranks at
   RANK_TOL) and coreness on "dense"; at primaries equal to the unsplit
   graph's "ell" run (PageRank within 1e-5), CC and triangles also to
   scipy's.  `ell_hindex`, `ell_cc`, `ell_pagerank`, `ell_multi`,
   `ell_triangles` and `kcore_hindex` must launch, and each equals its
   plain version on the split rows and on `run_common_mirror`'s
   canonical rows.  Prints the "ell" coreness seconds split and unsplit,
   the merge's device ms per superstep (and the JAX package's comparison
   cube's), `run_common_mirror`'s host seconds.  Then a
   `MirrorStream(backend="ell", cc_labels=True, auto_grow=True)` in
   windows of R: 8 inserts onto the heaviest hub, inserts pushing 4
   vertices of degree 57..64 past the threshold (on-line splits), 100
   seeded deletes of hub-incident edges, `grow(Cn=2·Cn)`, `save_session`
   and `restore_session`, the 100 re-inserts; after every window core and
   labels equal a fresh mirrored recompute and, at primaries in original
   ids, the unsplit recompute of the same edges, and a "torch" run of the
   same steps holds the same graph, plan, core, labels and stats
   (`apply_mirrored_edits`' host ms per window).  Last, `QueryServer`
   over a fresh MirrorStream, SERVICE_CONFIG, the `mixed` mix over the
   first 12 windows: every snapshot equals its epoch's mirrored
   recompute, every answer that recompute's read through `primary`
   (replica rows among the ids), `nbr_max` the max coreness over each
   logical neighborhood.
12. scale: a 2^21-node random ELL graph (Cd = 32, ~256 MB of nbr): static
   coreness and a 64-update intra-block stream, then CC, PageRank and
   triangle counts, held the same way (the dense adjacency would be
   8.8 TB there); then `ell_cc`, `ell_pagerank`, `ell_multi`,
   `ell_triangles`, `ell_hindex_count` and `ell_allpairs` timed there,
   with `deg` and without (its nbr does not fit the L2).
13. timing: each kernel and its plain version at the main path's shapes
   (`ell_hindex` at both: the stream's K = Cd and the static fixpoint's
   degree bound, and `ell_frontier` at the first hop, R = 8 and R = 1,
   each with the row lengths `deg` as the main path passes them and
   without, beside the all-columns bound, the row-length bound and a
   launch floor: one one-element PyTorch op timed the same way;
   `kcore_hindex` at both, K = 150 and 128; `frontier` on
   the main path's folded masks and with every row live; the combines
   and the two variants at the analytics shapes, `ell_cc`,
   `ell_pagerank`, `ell_multi` and the whole `ell_triangles` wrapper with
   `deg` and without, beside the same two bounds and the launch floor,
   the variants beside both bounds; `torch.sparse.mm` beside the sum, and
   a product-only `torch.matmul` beside the two dense kernels), by CUDA
   events between 20 back-to-back calls after warm-up,
   the median, beside the bytes bound at 3.35 TB/s and, where it is the
   larger, the operations bound.

14. audit_ds1: the port's tracelint (`repro_torch.analysis`): its CLI
   with ``--check --no-audit`` on the checkout (the AST rules, the
   dead-seed and port-import audits); then every entry of its `MANIFEST`
   on the card, on the tiny graph and on DS1 (the clean-window entries on
   the first R = 8 window of the 200-update stream that routes clean,
   else on its first update that does; the escalated-window entry on the
   stream's first window, the main path's), each under the host-read
   counter and CUDA's sync detector (``set_sync_debug_mode("warn")``),
   the pure entries also under ``"error"``.  One line per entry: host
   reads, CUDA syncs, both budgets and the JAX package's, supersteps,
   wall ms, the kernels' launches and where each read and sync sits.
   Raises on any finding; `ell_hindex`, `ell_frontier`, `ell_cc`,
   `ell_multi` and `ell_pagerank` must launch on DS1.
15. serve_lm: the LM substrate's serve path (`repro_torch.models`, which
   reaches no CUDA kernel of the port) at published widths in bfloat16,
   for all ten architectures: internlm2-1.8b, gemma3-1b, codeqwen1.5-7b
   and paligemma-3b at full depth, deepseek-v3-671b at 5 of 61 layers
   (its 3 dense MLA layers and 2 MoE layers), llama4-scout-17b-a16e at
   12 of 48 and granite-34b at 52 of 88 (`SERVE_DEPTH`: the published
   depth does not fit one card; each line lists the cut under
   `reduced`), mamba2-370m, zamba2-7b and seamless-m4t-large-v2 (24
   encoder and 24 decoder layers) at full depth: `build`, `init` on the
   card from a seed, then 4 seeded prompts of 1,024 tokens (paligemma:
   after 256 seeded stub patch embeddings of width 1,152, prefilled with
   them at position 0; decode from 256 + 1,024).  seamless instead times
   `prefill_fn` (the encoder) over 4 x 4,096 seeded stub frame
   embeddings and `encdec_prime_cross`, feeds 64 decoder tokens one a
   step and takes 32 greedy steps; its (a) holds every served logit
   against `encdec_forward` on the fed tokens, and its line gives decode
   ms beside the bytes of the decoder's layers, lm_head and primed cross
   K/V at 3.35 TB/s.  Attention models
   block-prefill them into a full cache through `decode_fn` and take 32
   greedy decode steps on the capacity MoE path; mamba models time
   `prefill_fn(last_only=True)` (the chunked scan) over them, build their
   caches token by token over the first 64 tokens and take the 32 steps
   from there.  Raises unless (a) the served logits match the forward on
   the same tokens (the dense models: all 1,056; the MoE models: a fresh
   64-token block and 32 steps on the dense MoE path, whose decode and
   forward keep the same tokens, the forward's routers picking the
   experts the decode picked — bf16 rounding moves near-tied tokens to
   other experts, and the tokens whose own pick differs are counted;
   the mamba models: their 64 + 32, within SERVE_BF16_SSM_TOL), (b)
   the `last_only` logits the last row of the full ones, (c) gemma3's
   banded prefill the masked-full one (``REPRO_NO_BANDED=1`` set inside
   the phase and restored; the banded path must run once per local
   layer), (d) gemma3's ring and full caches agree over 576
   token-by-token steps, (g) one full-width MoE layer of each MoE model
   gives `moe_dense`'s output through `moe_capacity` with capacity T·k,
   (h) deepseek's absorbed decode its naive decode over the 32 served
   tokens from the prompt's cache (the dense MoE path, as the reference's
   test, the naive run's experts replayed; the absorbed serving steps
   are timed) — (a)-(d), (g), (h)
   within SERVE_BF16_TOL of the largest |logit| — (i) zamba2's shared
   block runs in each of its 13 periods of a forward and of a step on
   one parameter set (the same data_ptrs), (e) each model's reduced
   float32 config gives the CPU's logits on the card with the same
   parameters (forward, the prompt into the cache, 4 decode steps;
   SERVE_F32_TOL), and (f) every logit is finite.  One line per model:
   prefill seconds and tokens/s, decode ms a step (median; min, max) and
   tokens/s beside the parameter bytes at 3.35 TB/s (with the caches';
   MoE models also the bytes of a dispatch that read only the chosen
   experts), peak device bytes while serving, the errors, the tokens
   the compared runs routed to other experts, the card.
16. train_parts: training's parts that need no launcher
   (`repro_torch.optim`, `checkpoint.save_train_state`).  One AdamW
   `update` of internlm2-1.8b's whole bf16 parameter tree (from the
   serve seed) with seeded bf16 gradients (std 1e-3, above the clip
   norm), timed on the host clock (median of 3) and by CUDA events,
   beside its bytes (the gradients read twice, master, m and v read and
   written, the params written: 30 bytes a parameter) at 3.35 TB/s;
   sampled rows of every leaf against a float64 host recompute
   (TRAIN_TOL, the step in float32 ulps of the master), the params the
   new master in bf16 exactly, the float32 global norm against float64
   (TRAIN_NORM_TOL).  Then the reduced model's float32 tree through
   three updates on the card and on the CPU (TRAIN_TOL), `quantize_int8`
   on the card bit-equal to the CPU (ties included),
   `compressed_psum_mean` on a one-rank NCCL group bit-equal to the
   CPU's quantizer, and `save_train_state` of the reduced card state
   (float32, and bf16 with bf16 moments, the second written
   asynchronously) restored on the CPU bit for bit.
17. train_lm: training end to end (`repro_torch.launch.train`).  (a)
   internlm2-1.8b and (b) mamba2-370m at published width and depth in
   bf16, random weights from TRAIN_LM_SEED: TRAIN_LM_STEPS steps of
   `make_step` (the loss with remat, its backward, the AdamW update) on
   B x S = 4 x 1,024 `SyntheticTokens`, the first a warm-up; step ms
   (median, min, max; host clock around work ending in a synchronize),
   tokens/s and each loss (finite) beside the bound: 8 x the matmul
   parameters x tokens (6 x without remat) plus 4 x (3 x) the causal
   attention's or the SSD scan's forward products at the H100's dense
   bf16 peak (989 TFLOP/s, NVIDIA's data sheet), plus the update's 30
   bytes a parameter at 3.35 TB/s; the step's peak bytes, and the loss
   and backward's peak with remat and without, which must be higher.
   (c) Every architecture's reduced float32 config, TRAIN_LM_RED_STEPS
   steps on the card against the CPU: losses, m and v within
   TRAIN_LM_TOL of their values, params and master by the update they
   took from the start, within TRAIN_LM_UPDATE_TOL of the leaf's
   largest update (entries whose gradient is within float32 noise of
   zero excepted, counted and bounded: TRAIN_LM_FLIP).  (d) The fault
   drill through the CLI on the card (`--simulate-failure 6` exits 42,
   `--resume auto` prints ``[resume] restored step 6`` and exits 0),
   its final checkpoint against an uninterrupted run's (bit-equal or
   within the same bounds, no entry excepted; reported), and a
   `--grad-compression` run on the launcher's one-rank NCCL group.  MoE
   models train here at reduced size only: llama4-scout's embeddings
   and one layer are 4.3·10⁹ parameters, 51 GB of float32 master, m
   and v.
18. lm_mesh: the production mesh's placement and the dry run
   (`distributed.sharding`, `launch.dryrun`, `launch.extrapolate`).
   (a) internlm2-1.8b at published width, bf16, B x S = 4 x 1,024: one
   launcher step (`make_step`) with the parameters, state and batch
   placed as DTensors on a (1, 1) mesh over a one-rank NCCL group,
   against the plain step of the same seed and batch: loss and every
   leaf of params, master, m and v equal bit for bit; each step's ms
   (after one warm-up each) and the placed step's peak bytes.  (b) The
   dry run of that cell on a (1, 1) fake mesh (fake CUDA tensors): its
   matmul FLOPs within LM_MESH_FLOP_TOL of `_step_flops` with its three
   named differences (the eager attention's masked half, computed; the
   logits' product, outside remat; each layer's down projection, which
   remat's recompute stops before), and its peak (arguments + the
   largest live temporaries) within LM_MESH_PEAK_TOL of the placed
   step's `max_memory_allocated`.  (c) In LM_MESH_WORKERS processes at
   once: `extrapolate_cell` for all ten architectures' `train_4k` on 16 x
   16 and for internlm2-1.8b's `decode_32k`, and full-depth `run_cell`
   of both internlm2 cells, each fit equal to its full depth exactly;
   every record's three roofline terms (H100 data-sheet rates, not
   measurements).  The phase must end within LM_MESH_SECONDS.

Earlier lines are JSON objects; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.
With no CUDA device, or without the repo's `src/repro_torch` beside it,
the script exits non-zero and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time
from contextlib import contextmanager
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

#: published HBM3 rate of one H100 SXM (bytes/s)
HBM_BYTES_PER_S = 3.35e12
#: published float32 rate of one H100 SXM outside the tensor cores (op/s),
#: the rate the integer compares of the triangle probes are counted at
SCALAR_OPS_PER_S = 67e12
#: published dense bf16 tensor-core rate of one H100 SXM (op/s), the rate
#: the dense kernels' matrix-product formulation is counted at
BF16_OPS_PER_S = 989e12
#: the kernels: name -> the wrapper (module.function under
#: repro_torch.kernels, carrying `.launches`) and the TPU kernel it replaces
KERNELS = {
    "ell_hindex": ("ell_hindex.hindex_ell",
                   "src/repro/kernels/ell_hindex.py:117"),
    "ell_frontier": ("ell_frontier.frontier_step_ell",
                     "src/repro/kernels/ell_frontier.py:107"),
    "ell_cc": ("ell_cc.neighbor_min_ell", "src/repro/kernels/ell_cc.py:102"),
    "ell_pagerank": ("ell_pagerank.neighbor_sum_ell",
                     "src/repro/kernels/ell_pagerank.py:66"),
    "ell_multi": ("ell_multi.neighbor_multi_ell",
                  "src/repro/kernels/ell_multi.py:100"),
    "ell_triangles": ("ell_triangles.neighbor_common_ell",
                      "src/repro/kernels/ell_triangles.py:167"),
    "ell_hindex_count": ("ell_hindex.hindex_count_ell",
                         "src/repro/kernels/ell_hindex.py:117"),
    "ell_allpairs": ("ell_triangles.common_allpairs_ell",
                     "src/repro/kernels/ell_triangles.py:167"),
    "kcore_hindex": ("kcore_hindex.hindex_counts",
                     "src/repro/kernels/kcore_hindex.py:81"),
    "frontier": ("frontier.frontier_step", "src/repro/kernels/frontier.py:66"),
    "cc_union": ("cc_union.union_find_labels",
                 "none: the JAX package labels components only by min-label "
                 "propagation (ell_cc)"),
}
#: the kernels of the dense backend, and the ELL kernels' variants
DENSE = ("kcore_hindex", "frontier")
VARIANTS = ("ell_hindex_count", "ell_allpairs")
#: the float sum's tolerance against the plain version (torch.sum adds in
#: another order); the ranks', after 30 supersteps of such sums
SUM_TOL = dict(rtol=1e-5, atol=1e-9)
RANK_TOL = dict(rtol=1e-4, atol=1e-9)
DS1_UPDATES = 200   # 50 each: inter/intra inserts, inter/intra deletes
SCALE_LOG2_N = 21   # the scale phase's node count, 2**21
SCALE_UPDATES = 64  # intra-block updates of the scale stream
R = 8               # stream window width
ELASTIC_THRESHOLD = 1.2  # the §4.2 balance threshold of elastic_ds1
ELASTIC_MOVES = 8        # at most this many migrated vertices a round
ELASTIC_CD = 256         # the explicit degree-capacity grow of elastic_ds1
#: service_ds1, the settings of the JAX package's benchmarks/bench_service.py
SERVICE_CONFIG = dict(max_queue=4096, max_batch=64, refresh_every=1,
                      pr_steps=10, alpha=0.85)
SERVICE_QPW = 48         # queries submitted before each window
SERVICE_SEED = 2         # the query feed's numpy seed
SERVICE_MIXED_K = 8      # the top-k width of the "mixed" mix
SERVICE_TOPK_MAX = 16    # the "topk" mix draws k from 1..16
#: the kernels a serving run must launch: the refresh's fused loop and the
#: stream's maintenance and CC recompute
SERVICE_KERNELS = ("ell_multi", "ell_hindex", "ell_frontier", "cc_union")
#: skew_egofb: benchmarks/bench_skew.py's graph at ego-Facebook's full size,
#: split at the bench's threshold
SKEW_THRESHOLD = 64
SKEW_SPLITS = 4          # vertices of degree 57..64 pushed past it
SKEW_DELETES = 100       # hub-incident deletes, re-inserted after restore
SKEW_SEED = 20           # the mirrored stream's numpy seed
SKEW_SERVICE_WINDOWS = 12
SKEW_RANK_ATOL = 1e-5    # split vs unsplit PageRank (the JAX tests' bar)
#: mirror_report's counters on that graph, as the JAX package gives them
SKEW_REPORT = dict(Cd_unsplit=1287, Cd_split=64, slots_unsplit=12_437_568,
                   slots_split=618_496, inter_unsplit=150_858,
                   inter_split=132_918, n_groups=461, replica_rows=703,
                   Gmax=512, Km=2048)
#: the kernels the mesh runtime runs on each shard (mesh_ds1: the
#: executor's primitives; mesh_programs_ds1: the programs and the stream),
#: whose launches the kernel line gives by path
MESH_KERNELS = ("ell_hindex", "ell_frontier", "ell_cc", "ell_pagerank",
                "ell_multi", "ell_triangles")
#: the kernels the mirrored static analytics launch on "ell"
SKEW_KERNELS = ("ell_hindex", "ell_cc", "ell_pagerank", "ell_multi",
                "ell_triangles")
#: the kernels the entry-point audit's manifest launches on DS1
AUDIT_KERNELS = ("ell_hindex", "ell_frontier", "ell_cc", "ell_multi",
                 "ell_pagerank")


def emit(**obj) -> None:
    print(json.dumps(obj), flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch" / "__init__.py").exists():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from the "
              "root of a checkout", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import _build

    dev = torch.device("cuda", 0)
    card = card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    emit(phase="build", seconds=time.perf_counter() - t0,
         sources=sorted(_build.SOURCES), card=card)

    g, core_plain = ds1_graph(dev)
    ups = sample_stream(g, DS1_UPDATES // 4, seed0=2)
    parity = kernel_parity(g, core_plain, dev, ups[:R])
    for part in (combine_parity(g, core_plain, dev),
                 dense_parity(g, core_plain, dev)):
        for name, e in part.items():  # the largest error over every phase
            parity[name] = max(parity.get(name, 0), e)
    launches, hindex_split, plain = _drive(g, ups, "main_path_ds1")
    launches.update(_drive_dense(g, ups, plain))
    launches_an, fields, plain_an = _analytics(g, "analytics_ds1", core_plain,
                                               ups)
    _analytics_dense(g, plain_an)
    launches_an.update(variants_phase(g, core_plain, plain["steps"],
                                      plain_an["tri"]))
    for name, e in elastic_phase(g, core_plain, ups).items():
        parity[name] = max(parity.get(name, 0), e)
    skew = skew_graph(dev, card)
    by_path = {"main_path_ds1": launches}
    by_path["mesh_ds1"], by_path["mesh_programs_ds1"], mesh_err = \
        mesh_phase(g, core_plain, ups, skew)
    for name, e in mesh_err.items():
        parity[name] = max(parity.get(name, 0), e)
    by_path["recovery_ds1"] = recovery_phase(g, core_plain, ups)
    service_phase(g, core_plain, ups, card)
    for name, e in skew_phase(*skew, card).items():
        parity[name] = max(parity.get(name, 0), e)
    scale = scale_phase(dev)
    kernels = timing(g, core_plain, ups[:R], parity, launches, hindex_split)
    kernels += combine_timing(g, fields, parity, launches_an,
                              kernels[0]["launch_floor_ms"], scale)
    kernels += dense_timing(g, core_plain, ups[:R], parity, launches)
    kernels.append(cc_union_phase(g, dev, launches_an))
    audit = audit_phase(g, ups, dev)
    serve_lm_phase(card)
    train_parts_phase(card, dev)
    train_lm_phase(card, dev)
    lm_mesh_phase(card, dev)
    for k in kernels:
        if k["name"] in MESH_KERNELS:
            k["launches_by_path"] = {p: c.get(k["name"], 0)
                                     for p, c in by_path.items()}
        k["launches_audit_ds1"] = audit.get(k["name"], 0)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def sample_stream(g, q: int, seed0: int, scenarios=("inter", "intra")):
    """q inserts and q deletes per scenario, as examples/kcore_dynamic.py
    builds them (seeds seed0, seed0+1, ... in that order)."""
    from repro_torch.core.updates import sample_deletions, sample_insertions

    ups, seed = [], seed0
    for sample in (sample_insertions, sample_deletions):
        for scen in scenarios:
            ups += sample(g, q, scen, seed=seed)
            seed += 1
    return ups


def ds1_graph(dev):
    """The DS1 graph on the card and its plain-backend coreness."""
    from repro_torch.core import build_blocks, coreness_with_stats
    from repro_torch.core.partition import node_bfs_partition
    from repro_torch.graphgen import snap_like

    t0 = time.perf_counter()
    edges = snap_like("DS1", 1.0, seed=7)
    n = int(edges.max()) + 1
    assign = node_bfs_partition(edges, n, 8, seed=1)
    g = build_blocks(edges, n, assign, P=8, deg_slack=64, device=dev)
    core, steps = coreness_with_stats(g, backend="torch")
    emit(phase="ds1_graph", n=n, m=int(len(edges)), N=g.N, Cd=g.Cd,
         max_degree=int(g.deg.max()), edge_cut=g.edge_cut(),
         plain_steps=steps, max_core=int(core.max()),
         host_seconds=time.perf_counter() - t0)
    return g, core


def _edge_rows(dev):
    """A small hand-made ELL graph that reaches every path of the two
    redesigned kernels: Cd = 300, more than the 256 columns `ell_hindex`
    keeps in a warp's registers; an all-PAD row, a full row (deg = Cd),
    rows of 31, 32, 33 (a frontier step), 64, 65 (a lane group's
    registers), 256 and 257 valid slots and random ones; est from -3 to
    Cd + 20 (values <= 0 and > C).  Returns (left-filled nbr, the same
    rows shuffled, deg, est) on `dev`."""
    import numpy as np
    import torch

    rng = np.random.default_rng(14)
    N, Cd = 512, 300
    lens = [0, Cd, 31, 32, 33, 64, 65, 256, 257, 1]
    deg = np.concatenate([lens, rng.integers(0, Cd + 1, N - len(lens))])
    nbr = np.full((N, Cd), -1, np.int32)
    shuffled = nbr.copy()
    for u in range(N):
        ids = np.sort(rng.choice(N, deg[u], replace=False))
        nbr[u, :deg[u]] = ids
        shuffled[u, rng.choice(Cd, deg[u], replace=False)] = ids
    est = rng.integers(-3, Cd + 21, N).astype(np.int32)
    return tuple(torch.as_tensor(a).to(dev) for a in
                 (nbr, shuffled, deg.astype(np.int32), est))


def _first_hop(g, core, window):
    """The masks of the first hop of the stream's first window, as
    `k_reachable_batch` builds them: (f, eligible, visited), (N, R) bool."""
    roots, ks = _window_roots(g, core, window)
    elig = ((core[:, None] == ks[None, :]) & g.node_mask[:, None]).contiguous()
    f = (roots & elig).contiguous()
    return f, elig, f.clone()


def kernel_parity(g, core, dev, window):
    """Every kernel against its plain version on the card, bit-equal; the
    two redesigned kernels with the row lengths `deg` and without.
    `window` is the stream's first window (the first-hop masks).  Returns
    {kernel name: max |kernel - plain| over all cases} (0)."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.ell_frontier import (
        frontier_step_ell, frontier_step_ell_plain)
    from repro_torch.kernels.ell_hindex import (
        hindex_count_ell_plain, hindex_ell, hindex_ell_plain)

    gen = torch.Generator(device=dev).manual_seed(0)
    nbr, N, Cd = g.nbr, g.N, g.Cd
    shuffled = nbr.gather(
        1, torch.rand((N, Cd), generator=gen, device=dev).argsort(dim=1))
    ests = {
        "degrees": g.deg,
        "random": torch.randint(-2, Cd + 10, (N,), generator=gen,
                                device=dev, dtype=torch.int32),
        "coreness": core,
    }
    Kb = ops.degree_bound(g)  # K < Cd: reads part of the row
    e_nbr, e_shuf, e_deg, e_est = _edge_rows(dev)
    with_deg = (("", None), ("/deg", g.deg))
    e_with_deg = (("", None), ("/deg", e_deg))
    cases = [(f"{e}/K={k}{dn}", nbr, est, k, d) for e, est in ests.items()
             for k in (None, Kb) for dn, d in with_deg]
    cases += [(f"shuffled/random/K={k}{dn}", shuffled, ests["random"], k, d)
              for k in (None, Kb) for dn, d in with_deg]
    holes = _holes(nbr, g.deg)
    cases += [(f"holes/random/K={k}{dn}", holes, ests["random"], k, d)
              for k in (None, Kb) for dn, d in with_deg]
    e_holes = _holes(e_nbr, e_deg)
    e_layouts = (("edge", e_nbr), ("edge/shuffled", e_shuf),
                 ("edge/holes", e_holes))
    cases += [(f"{an}/K={k}{dn}", nb, e_est, k, d) for an, nb in e_layouts
              for k in (None, 64, 257) for dn, d in e_with_deg]
    err = {"ell_hindex": 0, "ell_frontier": 0, "ell_hindex_count": 0,
           "ell_allpairs": 0}
    for name, nb, est, K, d in cases:
        got = hindex_ell(nb, est, K=K, deg=d)
        want = hindex_ell_plain(nb, est, K)
        cnt = hindex_ell(nb, est, K=K, variant="count", deg=d)
        cnt_plain = hindex_count_ell_plain(nb, est, K)
        torch.cuda.synchronize()
        e = int((got.long() - want.long()).abs().max())
        err["ell_hindex"] = max(err["ell_hindex"], e)
        if e or not torch.equal(got, want):
            raise AssertionError(f"ell_hindex differs from plain on {name}")
        e = int((cnt.long() - cnt_plain.long()).abs().max())
        err["ell_hindex_count"] = max(err["ell_hindex_count"], e)
        if e or not torch.equal(cnt, cnt_plain) or not torch.equal(cnt, got):
            raise AssertionError(f"ell_hindex_count differs from its plain "
                                 f"version or from ell_hindex on {name}")
    tri_cases = [(f"{an}/K={k}", nb, nb, k, g.deg) for an, nb in
                 (("sorted", nbr), ("shuffled", shuffled), ("holes", holes))
                 for k in (None, Kb)]
    _allpairs_parity(tri_cases, err)

    def masks(n, Rr, p_f=0.2):
        return tuple(torch.rand((n, Rr), generator=gen, device=dev) < p
                     for p in (p_f, 0.7, 0.2))

    hop = _first_hop(g, core, window)
    unaligned = torch.empty(N * R + 1, dtype=torch.bool, device=dev)[1:]
    unaligned = unaligned.view(N, R).copy_(hop[0])  # contiguous, odd address
    f_cases = []
    for an, nb in (("sorted", nbr), ("shuffled", shuffled)):
        for dn, d in with_deg:
            for Rr in (1, 8, 13):
                f_cases.append((f"R={Rr}/{an}{dn}", nb, masks(N, Rr), None, d))
            f_cases.append((f"first_hop/{an}{dn}", nb, hop, None, d))
            f_cases.append((f"first_hop/K={Kb}/{an}{dn}", nb, hop, Kb, d))
            f_cases.append((f"first_hop/f_unaligned/{an}{dn}", nb,
                            (unaligned,) + hop[1:], None, d))
    for an, nb in (("edge", e_nbr), ("edge/shuffled", e_shuf)):
        for dn, d in e_with_deg:
            for Rr in (1, 8, 13):
                for K in (None, 64):
                    f_cases.append((f"{an}/R={Rr}/K={K}{dn}", nb,
                                    masks(nb.shape[0], Rr, 0.02), K, d))
    for name, nb, (f, elig, vis), K, d in f_cases:
        got = frontier_step_ell(nb, f, elig, vis, K=K, deg=d)
        want = frontier_step_ell_plain(nb, f, elig, vis, K)
        torch.cuda.synchronize()
        e = int((got != want).sum().clamp(max=1))
        err["ell_frontier"] = max(err["ell_frontier"], e)
        if not torch.equal(got, want):
            raise AssertionError(f"ell_frontier differs from plain on {name}")
    gen_np = np.random.default_rng(15)
    e_fields = {"hindex": e_est,
                "min": torch.as_tensor(gen_np.integers(
                    -5, e_nbr.shape[0] + 5, e_nbr.shape[0],
                    dtype=np.int32)).to(dev),
                "sum": _order_floats(e_nbr.shape[0], gen_np, dev)}
    e_dup = _dup_field(e_nbr.shape, gen_np, dev)
    # the field is nbr itself (so deg bounds its rows too), a copy of it
    # (read over its C columns) or duplicate ids
    e_tri_cases = [(f"{an}/{fn}/K={k}", nb, rows, k, e_deg)
                   for an, nb in e_layouts
                   for fn, rows in (("rows=nbr", nb), ("rows=copy", nb.clone()),
                                    ("rows=dup", e_dup))
                   for k in (None, 64, 257)]
    _allpairs_parity(e_tri_cases, err)
    e_rand = torch.rand(e_nbr.shape[0], generator=gen, device=dev)
    fused_cases, min_sum_cases = [], []
    for an, nb in e_layouts:
        for K in (None, 64, 257):
            fused_cases += _fused_parity(nb, e_deg, K, e_fields, e_dup,
                                         f"{an}/K={K}", err,
                                         sum_vs_plain=False)
            min_sum_cases += _min_sum_parity(
                nb, e_deg, K, {"random": e_fields["min"]},
                {"random": e_rand}, f"{an}/K={K}", err)
            min_sum_cases += _min_sum_parity(
                nb, e_deg, K, {}, {"order_floats": e_fields["sum"]},
                f"{an}/K={K}", err, sum_vs_plain=False)
    emit(phase="kernel_parity", hindex_cases=[c[0] for c in cases],
         frontier_cases=[c[0] for c in f_cases],
         allpairs_cases=[c[0] for c in tri_cases + e_tri_cases],
         multi_triangles_cases=fused_cases, min_sum_cases=min_sum_cases,
         max_abs_err=err)
    return err


def _allpairs_parity(cases, err):
    """`ell_allpairs` on each case (name, nbr, field, K, deg), with the row
    lengths and without, bit-equal to its plain version and to the "merge"
    kernel called the same way.  Updates `err`."""
    import torch
    from repro_torch.kernels.ell_triangles import (
        common_allpairs_ell_plain, neighbor_common_ell)

    for name, nb, rows, K, d in cases:
        want = common_allpairs_ell_plain(nb, rows, K)
        for dn, dd in (("", None), ("/deg", d)):
            got = neighbor_common_ell(nb, rows, K, variant="allpairs", deg=dd)
            merge = neighbor_common_ell(nb, rows, K, deg=dd)
            torch.cuda.synchronize()
            e = int((got.long() - want.long()).abs().max())
            err["ell_allpairs"] = max(err["ell_allpairs"], e)
            if e or not torch.equal(got, want) or not torch.equal(got, merge):
                raise AssertionError(f"ell_allpairs differs from its plain "
                                     f"version or from ell_triangles on "
                                     f"{name}{dn}")


def _order_floats(n, rng, dev):
    """float32 values whose row sums depend on the order of the additions:
    1e8 beside 1.0, both signs, 3e-8 and -0.0."""
    import numpy as np
    import torch

    vals = np.array([1e8, -1e8, 1.0, -1.0, 0.5, -0.0, 3e-8], np.float32)
    return torch.as_tensor(rng.choice(vals, n)).to(dev)


def _dup_field(shape, rng, dev):
    """A row field with duplicate ids and stray negatives (legal in a raw
    field, not in a validated graph)."""
    import numpy as np
    import torch

    n = shape[0]
    rows = rng.integers(-2, max(2, n // 4), size=shape).astype(np.int32)
    rows[rng.random(shape) < 0.3] = -1
    return torch.as_tensor(rows).to(dev)


def _min_sum_parity(nb, deg, K, ints, floats, name, err, sum_vs_plain=True):
    """`ell_cc` and `ell_pagerank` on adjacency `nb` at column bound K, with
    the row lengths `deg` and without: every min (fields `ints`) bit-equal
    to plain; every sum (fields `floats`) bit-equal with `deg` and without,
    and within SUM_TOL of plain (unless `sum_vs_plain` is False: fields
    whose sums depend on the order of the additions).  Updates `err` (the
    sum's error against plain) and returns the case names."""
    import torch
    from repro_torch.kernels.ell_cc import (
        neighbor_min_ell, neighbor_min_ell_plain)
    from repro_torch.kernels.ell_pagerank import (
        neighbor_sum_ell, neighbor_sum_ell_plain)

    names = []
    err.setdefault("ell_cc", 0)
    for fn, f in ints.items():
        want = neighbor_min_ell_plain(nb, f, K)
        for dn, d in (("", None), ("/deg", deg)):
            if not torch.equal(neighbor_min_ell(nb, f, K, deg=d), want):
                raise AssertionError(f"ell_cc differs from plain: {name}{dn} "
                                     f"{fn}")
        names.append(f"min/{name}/{fn}")
    for fn, f in floats.items():
        got = neighbor_sum_ell(nb, f, K)
        if not torch.equal(neighbor_sum_ell(nb, f, K, deg=deg).view(
                torch.int32), got.view(torch.int32)):
            raise AssertionError(f"ell_pagerank with deg != without: {name} "
                                 f"{fn}")
        if sum_vs_plain:
            want = neighbor_sum_ell_plain(nb, f, K)
            err["ell_pagerank"] = max(err.get("ell_pagerank", 0.0),
                                      float((got - want).abs().max()))
            if not torch.allclose(got, want, **SUM_TOL):
                raise AssertionError(f"ell_pagerank not close to plain: "
                                     f"{name} {fn}")
        names.append(f"sum/{name}/{fn}")
    torch.cuda.synchronize()
    return names


def _holes(nbr, deg, every=7):
    """`nbr` (left-filled) with, in every `every`-th row that holds 1 to
    Cd - 1 valid slots, its first slot moved to the last column: a PAD
    inside the row's `deg` prefix, so the row is read on past it."""
    import torch

    N, Cd = nbr.shape
    out = nbr.clone()
    rows = torch.arange(0, N, every, device=nbr.device)
    rows = rows[(deg[rows] > 0) & (deg[rows] < Cd)]
    out[rows, Cd - 1] = out[rows, 0]
    out[rows, 0] = -1
    return out


def _fused_parity(nb, deg, K, fields, dup, name, err, sum_vs_plain=True):
    """`ell_multi` and `ell_triangles` on adjacency `nb` at column bound K,
    with the row lengths `deg` and without, against their plain versions:
    every fused output bit-equal to its standalone kernel, with the same
    `deg` and without (the float sum bit for bit to `neighbor_sum_ell`),
    min and hindex bit-equal to plain,
    the sum within SUM_TOL of plain (unless `sum_vs_plain` is False: an
    order-exposing sum field, whose value depends on the order of the
    additions, which torch.sum does not share); the triangle counts
    bit-equal to plain on rows = nb (the same tensor, so `deg` bounds the
    field's rows too), on a copy of nb (read over its C columns) and on the
    duplicate-id field `dup`.  Updates `err` (the sum's error against plain
    for ell_multi) and returns the case names."""
    import torch
    from repro_torch.kernels.ell_cc import neighbor_min_ell
    from repro_torch.kernels.ell_hindex import hindex_ell
    from repro_torch.kernels.ell_multi import (
        neighbor_multi_ell, neighbor_multi_ell_plain)
    from repro_torch.kernels.ell_pagerank import neighbor_sum_ell
    from repro_torch.kernels.ell_triangles import (
        neighbor_common_ell, neighbor_common_ell_plain)

    alone = {"min": neighbor_min_ell, "sum": neighbor_sum_ell,
             "hindex": hindex_ell}
    names = []
    for combines in (("hindex", "min", "sum"), ("hindex",), ("min",),
                     ("sum",), ("sum", "hindex")):
        fs = [fields[c] for c in combines]
        want = neighbor_multi_ell_plain(nb, fs, combines, K)
        for dn, d in (("", None), ("/deg", deg)):
            got = neighbor_multi_ell(nb, fs, combines, K, deg=d)
            for c, f, g_, w in zip(combines, fs, got, want):
                bits = g_.view(torch.int32)
                if not (torch.equal(bits, alone[c](nb, f, K).view(torch.int32))
                        and torch.equal(bits, alone[c](nb, f, K, deg=d).view(
                            torch.int32))):
                    raise AssertionError(f"ell_multi {c} != standalone "
                                         f"kernel: {name}{dn} {combines}")
                if c == "sum":
                    if not sum_vs_plain:
                        continue
                    err["ell_multi"] = max(err.get("ell_multi", 0.0),
                                           float((g_ - w).abs().max()))
                    ok = torch.allclose(g_, w, **SUM_TOL)
                else:
                    ok = torch.equal(g_, w)
                if not ok:
                    raise AssertionError(f"ell_multi {c} differs from plain: "
                                         f"{name}{dn} {combines}")
        names.append(f"multi/{name}/{'+'.join(combines)}")
    for fn, rows in (("rows=nbr", nb), ("rows=copy", nb.clone()),
                     ("rows=dup", dup)):
        want = neighbor_common_ell_plain(nb, rows, K)
        for dn, d in (("", None), ("/deg", deg)):
            got = neighbor_common_ell(nb, rows, K, deg=d)
            if not torch.equal(got, want):
                raise AssertionError(f"ell_triangles differs from plain: "
                                     f"{name}{dn} {fn}")
        names.append(f"triangles/{name}/{fn}")
    err.setdefault("ell_triangles", 0)
    torch.cuda.synchronize()
    return names


def _symmetric_rows(nbr):
    """The undirected ELL graph of `nbr`'s slots and their reverses, self
    loops dropped: (nbr, deg), rows sorted with PAD last, Cd the largest
    degree."""
    import torch

    N = nbr.shape[0]
    rows, cols = torch.nonzero(nbr >= 0, as_tuple=True)
    u, v = rows, nbr[rows, cols].long()
    key = torch.unique(torch.cat([u * N + v, v * N + u]))
    key = key[key // N != key % N]
    src, dst = key // N, key % N
    deg = torch.bincount(src, minlength=N)
    pos = torch.arange(src.numel(), device=nbr.device) - \
        (deg.cumsum(0) - deg)[src]
    out = torch.full((N, int(deg.max())), -1, dtype=torch.int32,
                     device=nbr.device)
    out[src, pos] = dst.to(torch.int32)
    return out, deg.to(torch.int32)


def cc_union_phase(g, dev, launches):
    """`cc_union` (module docstring, phase 2) against its plain version on
    the card and against `connected_components`, bit for bit, 20 launches
    a case; then its device µs on DS1 beside the plain version's and the
    bound of a superstep's least bytes (the valid slots, `deg` and the
    field read, a label written a row).  `launches` are the analytics
    path's (its CC-keeping stream).  Returns its line of the kernel
    table."""
    import torch
    from repro_torch.core import connected_components
    from repro_torch.kernels.cc_union import (
        union_find_labels, union_find_labels_plain)

    what = "cc_union"
    gen = torch.Generator(device=dev).manual_seed(2)
    N, Cd = g.N, g.Cd
    shuffled = g.nbr.gather(
        1, torch.rand((N, Cd), generator=gen, device=dev).argsort(dim=1))
    e_nbr, e_deg = _symmetric_rows(_edge_rows(dev)[0])
    e_mask = torch.ones(e_nbr.shape[0], dtype=torch.bool, device=dev)
    e_shuf = e_nbr.gather(1, torch.rand(e_nbr.shape, generator=gen,
                                        device=dev).argsort(dim=1))
    cases = {"ds1": (g.nbr, g.deg, g.node_mask),
             "ds1/shuffled": (shuffled, g.deg, g.node_mask),
             "ds1/holes": (_holes(g.nbr, g.deg), g.deg, g.node_mask),
             "edge_sym": (e_nbr, e_deg, e_mask),
             "edge_sym/shuffled": (e_shuf, e_deg, e_mask),
             "edge_sym/holes": (_holes(e_nbr, e_deg), e_deg, e_mask)}
    want = connected_components(g)
    err, components = 0, {}
    union_find_labels.launches = 0
    for name, (nb, d, m) in cases.items():
        plain = union_find_labels_plain(nb, d, m)
        if name.startswith("ds1") and not torch.equal(plain, want):
            raise AssertionError(f"{what}: plain != connected_components "
                                 f"on {name}")
        for _ in range(20):
            got = union_find_labels(nb, d, m)
            e = int((got.long() - plain.long()).abs().max())
            err = max(err, e)
            if e or not torch.equal(got, plain):
                raise AssertionError(f"{what} differs from plain on {name}")
        components[name] = int(torch.unique(plain[m]).numel())
    if union_find_labels.launches != 20 * len(cases):
        raise AssertionError(f"{what}: {union_find_labels.launches} launches")
    args = (g.nbr, g.deg, g.node_mask)
    ms, plain_ms = _time_pair(lambda: union_find_labels(*args),
                              lambda: union_find_labels_plain(*args),
                              plain_reps=5)
    nbytes = 4 * int(g.deg.sum()) + 3 * 4 * N
    emit(phase=what, cases=sorted(cases), components=components,
         edge_sym_Cd=int(e_nbr.shape[1]), max_abs_err=err, ms=ms,
         plain_ms=plain_ms, bound_bytes=nbytes, bound_ms=_bound_ms(nbytes),
         launches=launches.get(what, 0))
    return {"name": what, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{what}.cu",
            "replaces": KERNELS[what][1], "launches": launches.get(what, 0),
            "parity": "bit-equal", "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": _bound_ms(nbytes),
            "bound_by": "bytes", "bound_bytes": nbytes}


def combine_parity(g, core, dev):
    """The four combine kernels against their plain versions on the card,
    on the DS1 adjacency, its rows shuffled and its rows with holes (a PAD
    inside the `deg` prefix of every 7th row, `_holes`), at K = Cd and at
    the degree bound, each with the row lengths `deg` and without:
    `ell_cc` and `ell_pagerank` (`_min_sum_parity`), `ell_multi` and
    `ell_triangles` (`_fused_parity`), also on order-exposing floats and a
    duplicate-id field.  Returns {kernel name: max |kernel - plain| over
    all cases}."""
    import numpy as np
    import torch
    from repro_torch.core import connected_components, pagerank
    from repro_torch.core.algorithms import PageRankProgram
    from repro_torch.kernels import ops

    gen = torch.Generator(device=dev).manual_seed(1)
    nbr, N, Cd = g.nbr, g.N, g.Cd
    shuffled = nbr.gather(
        1, torch.rand((N, Cd), generator=gen, device=dev).argsort(dim=1))
    labels = connected_components(g, backend="torch")
    rank = pagerank(g, tol=None, max_steps=30, backend="torch")
    ints = {"random": torch.randint(-5, N + 5, (N,), generator=gen,
                                    device=dev, dtype=torch.int32),
            "cc_labels": torch.where(g.node_mask, labels,
                                     torch.iinfo(torch.int32).max)}
    floats = {"pagerank_contrib": PageRankProgram._contrib(g.deg, rank),
              "random": torch.rand(N, generator=gen, device=dev)}
    adj = {"sorted": nbr, "shuffled": shuffled, "holes": _holes(nbr, g.deg)}
    rng = np.random.default_rng(1)
    order_floats = _order_floats(N, rng, dev)
    dup = _dup_field((N, Cd), rng, dev)
    Ks = {"K=Cd": None, "K=degree_bound": ops.degree_bound(g)}
    err = dict.fromkeys(("ell_cc", "ell_pagerank", "ell_multi",
                         "ell_triangles"), 0.0)
    cases = []
    for (an, nb), (kn, K) in ((a, k) for a in adj.items() for k in Ks.items()):
        cases += _min_sum_parity(nb, g.deg, K, ints, floats, f"{an}/{kn}",
                                 err)
        cases += _min_sum_parity(nb, g.deg, K, {},
                                 {"order_floats": order_floats},
                                 f"{an}/{kn}", err, sum_vs_plain=False)
        host = {"hindex": core, "min": ints["cc_labels"],
                "sum": floats["pagerank_contrib"]}
        cases += _fused_parity(nb, g.deg, K, host, dup, f"{an}/{kn}", err)
        order = dict(host, sum=order_floats)
        cases += _fused_parity(nb, g.deg, K, order, dup,
                               f"{an}/{kn}/order_floats", err,
                               sum_vs_plain=False)
    torch.cuda.synchronize()
    emit(phase="combine_parity", cases=cases, ints=sorted(ints),
         floats=sorted(floats), sum_tol=SUM_TOL, max_abs_err=err)
    return err


def dense_parity(g, core, dev):
    """The two dense kernels against their plain versions on DS1's dense
    adjacency, bit-equal.  Returns {kernel name: max |kernel - plain|}."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.ell_frontier import frontier_step_ell
    from repro_torch.kernels.ell_hindex import hindex_ell
    from repro_torch.kernels.frontier import frontier_step, frontier_step_plain
    from repro_torch.kernels.kcore_hindex import (
        hindex_counts, hindex_counts_plain)

    gen = torch.Generator(device=dev).manual_seed(2)
    N, Cd, nbr = g.N, g.Cd, g.nbr
    adj = ref.ell_to_dense(nbr, N)
    ests = {"degrees": g.deg,
            "random": torch.randint(-2, Cd + 10, (N,), generator=gen,
                                    device=dev, dtype=torch.int32),
            "coreness": core}
    Ks = (ops.degree_bound(g), Cd + 1)
    err = {"kcore_hindex": 0, "frontier": 0}
    for (en, est), K in ((e, k) for e in ests.items() for k in Ks):
        got, want = hindex_counts(adj, est, K), hindex_counts_plain(adj, est, K)
        torch.cuda.synchronize()
        e = int((got.long() - want.long()).abs().max())
        err["kcore_hindex"] = max(err["kcore_hindex"], e)
        if e or not torch.equal(got, want):
            raise AssertionError(f"kcore_hindex differs from plain: {en} K={K}")
        if en == "coreness" and not torch.equal(got, hindex_ell(nbr, est)):
            raise AssertionError(f"kcore_hindex differs from ell_hindex K={K}")
    ones = torch.ones(N, dtype=torch.bool, device=dev)
    for Rr in (1, 8, 13):
        f, elig, vis = (torch.rand((N, Rr), generator=gen, device=dev) < p
                        for p in (0.2, 0.7, 0.2))
        folded = (vis | ~elig).contiguous()
        shared = torch.rand(N, generator=gen, device=dev) < 0.7
        for name, el, vi in (("folded", ones, folded), ("shared", shared, vis)):
            got = frontier_step(adj, f, el, vi)
            want = frontier_step_plain(adj, f, el, vi)
            torch.cuda.synchronize()
            e = int((got != want).sum().clamp(max=1))
            err["frontier"] = max(err["frontier"], e)
            if e:
                raise AssertionError(f"frontier differs from plain: R={Rr} "
                                     f"{name}")
        if not torch.equal(frontier_step(adj, f, ones, folded),
                           frontier_step_ell(nbr, f, elig, vis)):
            raise AssertionError(f"frontier differs from ell_frontier R={Rr}")
    emit(phase="dense_parity", N=N, adjacency_bytes=ops.dense_bytes(N),
         hindex_cases=[f"{e}/K={k}" for e in ests for k in Ks],
         frontier_R=[1, 8, 13], frontier_eligibility=["folded", "shared"],
         max_abs_err=err)
    del adj
    torch.cuda.empty_cache()
    return err


def _check_same_stream(a, b, what):
    import torch

    if not (torch.equal(a.core, b.core) and torch.equal(a.g.nbr, b.g.nbr)
            and torch.equal(a.g.deg, b.g.deg) and a.stats == b.stats):
        raise AssertionError(f"{what}: stream differs from the plain one: "
                             f"{a.stats} vs {b.stats}")


def _wrapper(name):
    """The wrapper function of kernel `name` (it carries `.launches`)."""
    import importlib

    mod, fn = KERNELS[name][0].split(".")
    return getattr(importlib.import_module(f"repro_torch.kernels.{mod}"), fn)


def _counted(fn, names=("ell_hindex", "ell_frontier")):
    """Run fn with every kernel's launch count set to 0 just before and
    read just after; returns (fn's result, {kernel: launches}).  Raises if
    a kernel of `names` never launched."""
    import torch

    for name in KERNELS:
        _wrapper(name).launches = 0
    out = fn()
    torch.cuda.synchronize()
    counts = {name: _wrapper(name).launches for name in names}
    if min(counts.values()) < 1:
        raise AssertionError(f"a kernel of the path never launched: {counts}")
    return out, counts


def _drive(g, ups, what):
    """Static coreness + run_stream through the kernels, held against the
    same path on the plain backend and a fresh recompute.  Each path runs
    on its own copy of `g`.  Returns the kernels' launch counts."""
    import torch
    from repro_torch.core import coreness, coreness_with_stats
    from repro_torch.kernels.ell_hindex import hindex_ell
    from repro_torch.runtime import run_stream

    def path(backend):
        gc = g.clone()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        core, steps = coreness_with_stats(gc, backend=backend)
        static = hindex_ell.launches  # the rest are the stream's (K = Cd)
        res = run_stream(gc, core, ups, R=R, backend=backend)
        torch.cuda.synchronize()
        return core, steps, res, time.perf_counter() - t0, static

    (core, steps, res, secs, static), counts = _counted(lambda: path("ell"))
    core_p, steps_p, res_p, secs_p, _ = path("torch")
    if steps != steps_p or not torch.equal(core, core_p):
        raise AssertionError(f"{what}: ell coreness differs from plain "
                             f"({steps} vs {steps_p} supersteps)")
    _check_same_stream(res, res_p, what)
    fresh = coreness(res.g, backend="torch")
    if not torch.equal(fresh, res.core):
        raise AssertionError(f"{what}: maintained coreness != recompute")
    hindex_split = {"static": static, "stream": counts["ell_hindex"] - static}
    emit(phase=what, static_steps=steps, max_core=int(core.max()),
         stream_stats=res.stats._asdict(), launches=counts,
         ell_hindex_launches=hindex_split,
         path_seconds=secs, plain_path_seconds=secs_p)
    plain = {"core": core_p, "steps": steps_p, "stream": res_p,
             "seconds": secs_p}
    return counts, hindex_split, plain


def _drive_dense(g, ups, plain):
    """`_drive`'s path with backend="dense" on a copy of `g`, held against
    the plain run `plain` (as `_drive` returns it) and a fresh recompute.
    Returns the dense kernels' launch counts, the h-index's split into the
    static fixpoint's (K = the degree bound) and the stream's (K = Cd + 1)
    under "kcore_hindex_split"."""
    import torch
    from repro_torch.core import coreness, coreness_with_stats
    from repro_torch.kernels import ops
    from repro_torch.kernels.kcore_hindex import hindex_counts
    from repro_torch.runtime import run_stream

    what = "main_path_ds1_dense"

    def path():
        gc = g.clone()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        core, steps = coreness_with_stats(gc, backend="dense")
        static = hindex_counts.launches
        res = run_stream(gc, core, ups, R=R, backend="dense")
        torch.cuda.synchronize()
        return core, steps, res, time.perf_counter() - t0, static

    torch.cuda.reset_peak_memory_stats()
    (core, steps, res, secs, static), counts = _counted(path, DENSE)
    if steps != plain["steps"] or not torch.equal(core, plain["core"]):
        raise AssertionError(f"{what}: dense coreness differs from plain "
                             f"({steps} vs {plain['steps']} supersteps)")
    _check_same_stream(res, plain["stream"], what)
    if not torch.equal(coreness(res.g, backend="torch"), res.core):
        raise AssertionError(f"{what}: maintained coreness != recompute")
    split = {"static": static, "stream": counts["kcore_hindex"] - static}
    emit(phase=what, static_steps=steps, stream_stats=res.stats._asdict(),
         launches=counts, kcore_hindex_launches=split,
         adjacency_bytes=ops.dense_bytes(g.N),
         peak_device_bytes=torch.cuda.max_memory_allocated(),
         path_seconds=secs, plain_path_seconds=plain["seconds"])
    return dict(counts, kcore_hindex_split=split)


@contextmanager
def _host_timed(module, names):
    """Replace `module`'s functions `names` with wrappers that record each
    call's host seconds, between two device syncs; yields {name: [s]}."""
    import torch

    times = {n: [] for n in names}
    orig = {n: getattr(module, n) for n in names}

    def timed(n):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = orig[n](*args, **kwargs)
            torch.cuda.synchronize()
            times[n].append(time.perf_counter() - t0)
            return out
        return call

    for n in names:
        setattr(module, n, timed(n))
    try:
        yield times
    finally:
        for n in names:
            setattr(module, n, orig[n])


def _join_window(handles, g):
    """A window joining the new vertices (`add_vertices` handles) to the
    first real nodes of `g` (open-time ids) and to each other."""
    import torch

    real = torch.nonzero(g.node_mask).flatten()[:R - 1].tolist()
    return ([(handles[i % len(handles)], real[i], +1)
             for i in range(R - 1)] + [(handles[0], handles[1], +1)])


def _elastic_run(g, core, ups, backend, elastic, plan=None):
    """The elastic steps on a copy of `g` (see `elastic_phase`); without
    `elastic`, the same steps with no rebalancing and no checkpoint.
    `plan` is the (block, count) of `add_vertices` (default: the block
    with the fewest free rows, two more than it holds).  Returns (session,
    plan, seconds, {host seconds and snapshot bytes})."""
    import tempfile
    import torch
    from repro_torch.checkpoint import (
        CheckpointManager, restore_session, save_session)
    from repro_torch.core import connected_components
    from repro_torch.runtime import StreamSession

    def windows(sess, part):
        for i in range(0, len(part), R):
            sess.apply_window(part[i:i + R])

    half = len(ups) // 2
    gc = g.clone()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sess = StreamSession(
        gc, core.clone(), R=R, backend=backend,
        cc_labels=connected_components(gc, backend=backend),
        rebalance_threshold=ELASTIC_THRESHOLD if elastic else None,
        rebalance_max_moves=ELASTIC_MOVES, auto_grow=True)
    windows(sess, ups[:half])
    if plan is None:
        free = (~sess.g.node_mask).reshape(sess.g.P, sess.g.Cn).sum(1)
        b = int(free.argmin())
        plan = (b, int(free[b]) + 2)
    handles = sess.add_vertices(*plan)
    sess.apply_window(_join_window(handles, g))
    sess.grow(Cd=ELASTIC_CD)
    info = {}
    if elastic:
        with tempfile.TemporaryDirectory() as d:
            mgr = CheckpointManager(d)
            t = time.perf_counter()
            step = save_session(mgr, sess, blocking=False)
            info["save_seconds"] = time.perf_counter() - t
            mgr.wait()
            info["save_and_write_seconds"] = time.perf_counter() - t
            info["snapshot_bytes"] = sum(
                f.stat().st_size for f in (Path(d) / f"step_{step:08d}")
                .iterdir())
            t = time.perf_counter()
            _, sess, _ = restore_session(mgr, device=g.device)
            torch.cuda.synchronize()
            info["restore_seconds"] = time.perf_counter() - t
    windows(sess, ups[half:])
    torch.cuda.synchronize()
    return sess, plan, time.perf_counter() - t0, info


def _grown_parity(sess, window):
    """`ell_hindex`, `ell_frontier` and `ell_cc` against their plain
    versions on the session's grown graph (K = Cd and the degree bound,
    with the row lengths `deg` and without); `window` gives the first-hop
    masks.  Returns {kernel: max |kernel - plain|} (0)."""
    import torch
    from repro_torch.core.algorithms import INT32_MAX
    from repro_torch.kernels import ops
    from repro_torch.kernels.ell_frontier import (
        frontier_step_ell, frontier_step_ell_plain)
    from repro_torch.kernels.ell_hindex import hindex_ell, hindex_ell_plain

    g, core = sess.g, sess.core
    Ks = (None, ops.degree_bound(g))
    with_deg = (None, g.deg)
    err = {"ell_hindex": 0, "ell_frontier": 0}
    for est in (core, g.deg):
        for K in Ks:
            want = hindex_ell_plain(g.nbr, est, K)
            for d in with_deg:
                got = hindex_ell(g.nbr, est, K=K, deg=d)
                torch.cuda.synchronize()
                e = int((got.long() - want.long()).abs().max())
                err["ell_hindex"] = max(err["ell_hindex"], e)
                if e:
                    raise AssertionError("elastic_ds1: ell_hindex differs "
                                         f"from plain on the grown graph")
    hop = _first_hop(g, core, window)
    for K in Ks:
        want = frontier_step_ell_plain(g.nbr, *hop, K)
        for d in with_deg:
            got = frontier_step_ell(g.nbr, *hop, K=K, deg=d)
            torch.cuda.synchronize()
            e = int((got != want).sum().clamp(max=1))
            err["ell_frontier"] = max(err["ell_frontier"], e)
            if e:
                raise AssertionError("elastic_ds1: ell_frontier differs "
                                     "from plain on the grown graph")
    gen = torch.Generator(device=g.device).manual_seed(18)
    ints = {"cc_labels": torch.where(g.node_mask, sess.labels, INT32_MAX),
            "random": torch.randint(-5, g.N + 5, (g.N,), generator=gen,
                                    device=g.device, dtype=torch.int32)}
    for K in Ks:
        _min_sum_parity(g.nbr, g.deg, K, ints, {}, f"grown/K={K}", err)
    return err


def elastic_phase(g, core, ups):
    """The elastic stream on DS1 (module docstring, phase 7), through the
    kernels and the plain versions, held against each other, against the
    same steps without rebalancing or checkpoint, and against a fresh
    recompute.  Returns the grown-graph parity errors."""
    import numpy as np
    import torch
    from repro_torch.core import (
        connected_components, coreness, to_networkx_edges)
    from repro_torch.core import partition_dynamic as pd
    from repro_torch.runtime import stream as stream_mod

    what = "elastic_ds1"
    with _host_timed(stream_mod, ("migrate_vertices", "grow_blocks")) as \
            host, _host_timed(pd, ("choose_node_moves",)) as moves_host:
        (sess, plan, secs, info), counts = _counted(
            lambda: _elastic_run(g, core, ups, "ell", True),
            ("ell_hindex", "ell_frontier", "ell_cc"))
    plain, _, secs_p, _ = _elastic_run(g, core, ups, "torch", True, plan)
    st = sess.stats()
    if not (torch.equal(sess.core, plain.core)
            and torch.equal(sess.labels, plain.labels)
            and all(torch.equal(a, b) for a, b in zip(
                (sess.g.nbr, sess.g.deg, sess.g.node_mask, sess.g.orig_id),
                (plain.g.nbr, plain.g.deg, plain.g.node_mask,
                 plain.g.orig_id)))
            and st == plain.stats()):
        raise AssertionError(f"{what}: ell differs from plain: {st} vs "
                             f"{plain.stats()}")
    if st.migrations < 1 or st.grows != 2:
        raise AssertionError(f"{what}: expected migrations and 2 grows: {st}")
    still, _, secs_s, _ = _elastic_run(g, core, ups, "ell", False, plan)

    def by_orig(s):
        orig, c = s.g.orig_id.cpu().numpy(), s.core.cpu().numpy()
        out = np.full(int(orig.max()) + 1, -1, c.dtype)
        out[orig[orig >= 0]] = c[orig >= 0]
        return out

    if not (np.array_equal(by_orig(sess), by_orig(still))
            and np.array_equal(to_networkx_edges(sess.g),
                               to_networkx_edges(still.g))):
        raise AssertionError(f"{what}: differs from the run without "
                             "rebalancing read through orig_id")
    if not (torch.equal(coreness(sess.g, backend="torch"), sess.core)
            and torch.equal(connected_components(sess.g, backend="torch"),
                            sess.labels)):
        raise AssertionError(f"{what}: maintained core/labels != recompute")
    window = [(sess._cur(u), sess._cur(v), op)
              for u, v, op in ups[len(ups) // 2:][:R]]
    err = _grown_parity(sess, window)
    emit(phase=what, N=sess.g.N, Cn=sess.g.Cn, Cd=sess.g.Cd,
         add_vertices=dict(block=plan[0], count=plan[1]),
         block_balance=dict(open=pd.block_balance(g),
                            end=pd.block_balance(sess.g),
                            end_without_rebalance=pd.block_balance(still.g)),
         stream_stats=st._asdict(), launches=counts,
         path_seconds={"ell": secs, "torch": secs_p,
                       "ell_without_rebalance_or_checkpoint": secs_s},
         choose_node_moves_seconds=moves_host["choose_node_moves"],
         migrate_seconds=host["migrate_vertices"],
         grow_seconds=host["grow_blocks"], max_abs_err=err, **info)
    return err


def _free_port() -> int:
    import socket

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def _window_roots(g, core, window):
    """The k-reachability inputs of a window, as the stream builds them:
    roots (N, R) at both endpoints of each update, ks = min endpoint
    coreness."""
    import torch

    us = torch.tensor([u for u, _, _ in window], device=g.device)
    vs = torch.tensor([v for _, v, _ in window], device=g.device)
    cols = torch.arange(len(window), device=g.device)
    roots = torch.zeros((g.N, len(window)), dtype=torch.bool, device=g.device)
    roots[us, cols] = True
    roots[vs, cols] = True
    return roots, torch.minimum(core[us], core[vs]).to(torch.int32)


def _mesh_parity(ex, core, hop):
    """The two kernels against their plain versions at the executor's
    shapes: the shard's local-frame rows over a field of S + H + 2 rows
    (the shard and its halo buffer).  Returns {kernel: max error} (0)."""
    import torch
    from repro_torch.kernels.ell_frontier import (
        frontier_step_ell, frontier_step_ell_plain)
    from repro_torch.kernels.ell_hindex import hindex_ell, hindex_ell_plain

    est = ex._exchange(core.to(torch.int32).contiguous(), -1)
    f = ex._exchange(hop[0].to(torch.uint8), 0).view(torch.bool)
    err = {}
    for name, got, want in (
            ("ell_hindex", hindex_ell(ex._rows, est, K=ex._K, deg=ex.deg),
             hindex_ell_plain(ex._rows, est, ex._K)),
            ("ell_frontier",
             frontier_step_ell(ex._rows, f, hop[1], hop[2], K=ex._K,
                               deg=ex.deg),
             frontier_step_ell_plain(ex._rows, f, hop[1], hop[2], ex._K))):
        torch.cuda.synchronize()
        err[name] = int((got.long() - want.long()).abs().max())
        if err[name]:
            raise AssertionError(f"mesh_ds1: {name} differs from plain on "
                                 "the executor's field")
    return err


def mesh_phase(g, core, ups, skew):
    """mesh_ds1: the mesh runtime at W = 1 under a one-rank NCCL group, so
    the halo exchange and the convergence flag go through the real
    `all_to_all_single` / `all_reduce`.  `coreness_blocks`, one h-index
    superstep, one R = 8 frontier hop (`hindex_blocks` / `frontier_blocks`
    with ``backend="ell_spmd"``), `k_reachable_batch` and the clamped
    recompute of DS1's first window, all through one `SpmdExecutor`, equal
    the single-device "ell" results and superstep counts bit for bit.
    Prints the plan's host seconds, `apply_updates` host ms a window
    against `rebuild`, the fixpoints' ms per superstep against the
    single-device "ell" loop, and the two kernels' launches.  Then, under
    the same group, `mesh_programs_phase` (mesh_programs_ds1, with
    `skew` = `skew_graph`'s result).  Returns (mesh_ds1's launches,
    mesh_programs_ds1's launches, parity errors)."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.core import coreness_with_stats
    from repro_torch.core import kcore_dynamic as kd
    from repro_torch.core.updates import apply_updates_host
    from repro_torch.kernels import ops
    from repro_torch.runtime import (
        SpmdExecutor, build_halo_plan, make_worker_mesh)

    what = "mesh_ds1"
    dist.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{_free_port()}",
        world_size=1, rank=0)
    try:
        # NCCL builds its communicator at the first collective: pay that
        # here, outside every timed call
        t0 = time.perf_counter()
        dist.all_reduce(torch.zeros(1, device=g.device))
        torch.cuda.synchronize()
        nccl_init_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        wm = make_worker_mesh(g)
        plan = build_halo_plan(g, wm)
        plan_s = time.perf_counter() - t0
        ex = SpmdExecutor(g, wm=wm, plan=plan)
        window = ups[:R]
        roots, ks = _window_roots(g, core, window)
        hop = _first_hop(g, core, window)

        def walled(fn):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            return out, time.perf_counter() - t

        def path():
            (c, s), _ = walled(lambda: ops.coreness_blocks(
                g, backend="ell_spmd", executor=ex, with_steps=True))
            h = ops.hindex_blocks(g, core, backend="ell_spmd", executor=ex)
            f = ops.frontier_blocks(g, *hop, backend="ell_spmd", executor=ex)
            (v, vs), _ = walled(lambda: ex.k_reachable_batch(core, roots,
                                                             ks))
            cand = v.any(dim=1)
            ub = torch.where(cand, torch.minimum(core + 1, g.deg), core)
            (r, rs), _ = walled(lambda: ex.restricted_recompute(ub, cand))
            return (c, s), h, f, (v, vs), (r, rs), ub, cand

        ((c, s), h, f, (v, vs), (r, rs), ub, cand), counts = _counted(path)
        (c1, s1), _ = walled(lambda: coreness_with_stats(g, backend="ell"))
        v1, vs1 = kd.k_reachable_batch(g, core, roots, ks, backend="ell")
        r1, rs1 = kd._restricted_recompute(g, ub, cand, backend="ell")
        checks = {
            "coreness": torch.equal(c, c1) and s == s1,
            "hindex": torch.equal(h, ops.hindex_blocks(g, core,
                                                       backend="ell")),
            "frontier": torch.equal(f, ops.frontier_blocks(g, *hop,
                                                           backend="ell")),
            "k_reachable_batch": torch.equal(v, v1) and vs == vs1,
            "restricted_recompute": torch.equal(r, r1) and rs == rs1,
        }
        if not all(checks.values()):
            raise AssertionError(f"{what}: differs from the single-device "
                                 f"ell path: {checks}")
        err = _mesh_parity(ex, core, hop)
        # whole fixpoints on the host clock, in turns (ell, ell_spmd,
        # ell_spmd, ell), the smaller of each pair; and one superstep's
        # device work by CUDA events (`_time_ms`)
        walls = {"ell": [], "ell_spmd": []}
        for b in ("ell", "ell_spmd", "ell_spmd", "ell"):
            walls[b].append(walled(lambda: ops.coreness_blocks(
                g, backend=b, executor=ex if b == "ell_spmd" else None))[1])
        est = torch.where(g.node_mask, g.deg, 0).to(torch.int32)
        K = ops.degree_bound(g)

        def spmd_step():
            nxt = torch.minimum(est, ex._hindex_local(est))
            return ex._any_global(nxt != est)

        def ell_step():
            nxt = torch.minimum(est, ops.hindex_blocks(g, est, backend="ell",
                                                       K=K))
            return (nxt != est).any()

        step_ms = {"ell_spmd": min(_time_ms(spmd_step) for _ in range(2)),
                   "ell": min(_time_ms(ell_step) for _ in range(2))}

        # the halo plan under the stream's windows, on a copy of the graph
        gc, upd_ms, reb_ms = g.clone(), [], []
        for i in range(0, len(ups), R):
            w = ups[i:i + R]
            gc = apply_updates_host(gc, w)
            t = time.perf_counter()
            ex.apply_updates(gc, w)
            upd_ms.append((time.perf_counter() - t) * 1e3)
        maintained = ex.plan
        for _ in range(3):
            t = time.perf_counter()
            ex.rebuild(gc)
            reb_ms.append((time.perf_counter() - t) * 1e3)
        if not all(np.array_equal(getattr(maintained, k), getattr(ex.plan, k))
                   for k in ("send_idx", "recv_pos", "halo_ids",
                             "nbr_local")):
            raise AssertionError(f"{what}: maintained plan != rebuild")
        (c2, s2), _ = walled(lambda: ex.coreness())
        if not (torch.equal(c2, coreness_with_stats(gc, backend="ell")[0])):
            raise AssertionError(f"{what}: coreness after the stream's "
                                 "plan updates != single-device ell")
        emit(phase=what, W=wm.W, backend=dist.get_backend(), N=g.N,
             S=wm.S, H=plan.H, K=plan.K, device_elems=plan.device_elems,
             column_bound=ex._K, static_steps=s, reach_steps=vs,
             recompute_steps=rs, launches=counts,
             build_halo_plan_host_seconds=plan_s,
             apply_updates_host_ms={
                 "windows": len(upd_ms),
                 "median": statistics.median(upd_ms), "max": max(upd_ms)},
             rebuild_host_ms=sorted(reb_ms),
             nccl_first_collective_seconds=nccl_init_s,
             coreness_host_ms_per_superstep={
                 b: min(w) * 1e3 / s for b, w in walls.items()},
             superstep_device_ms=step_ms,
             plan_updates=ex.plan_updates, full_rebuilds=ex.full_rebuilds,
             max_abs_err=err)
        prog_counts, prog_err = mesh_programs_phase(g, core, ups, skew)
        return counts, prog_counts, {**err, **prog_err}
    finally:
        dist.destroy_process_group()


def _mesh_field_parity(ex, g, labels, rank):
    """`ell_cc`, `ell_pagerank`, `ell_multi` and `ell_triangles` against
    their plain versions on the executor's longer field: the shard's
    local-frame rows over ``cat([shard, halo buffer])`` (S + H + 2 rows)
    of the CC labels, the PageRank contributions and, for the triangles,
    the graph's global-id rows (the exchanged `TriangleCountProgram`
    field, a tensor other than the rows), with the shard's `deg` and
    column bounds as the programs pass them.  Returns {kernel: max abs
    error}; bit-equal, the sum to SUM_TOL."""
    import torch
    from repro_torch.kernels.ell_cc import (
        neighbor_min_ell, neighbor_min_ell_plain)
    from repro_torch.kernels.ell_multi import (
        neighbor_multi_ell, neighbor_multi_ell_plain)
    from repro_torch.kernels.ell_pagerank import (
        neighbor_sum_ell, neighbor_sum_ell_plain)
    from repro_torch.kernels.ell_triangles import (
        neighbor_common_ell, neighbor_common_ell_plain)

    what = "mesh_programs_ds1"
    rows, K, deg = ex._rows, ex._K, ex.deg
    contrib = torch.where(g.deg > 0, rank / g.deg.clamp(min=1), 0.0).to(
        torch.float32)
    lab = ex._exchange(labels.to(torch.int32), torch.iinfo(torch.int32).max)
    con = ex._exchange(contrib, 0.0)
    core = ex._exchange(g.deg.to(torch.int32), -1)
    nbr_rows = ex._exchange(g.nbr, -1)
    err = {}
    multi = neighbor_multi_ell(rows, (core, lab, con),
                               ("hindex", "min", "sum"), K=K, deg=deg)
    multi_p = neighbor_multi_ell_plain(rows, (core, lab, con),
                                       ("hindex", "min", "sum"), K)
    for name, got, want, exact in (
            ("ell_cc", neighbor_min_ell(rows, lab, K=K, deg=deg),
             neighbor_min_ell_plain(rows, lab, K), True),
            ("ell_pagerank", neighbor_sum_ell(rows, con, K=K, deg=deg),
             neighbor_sum_ell_plain(rows, con, K), False),
            ("ell_multi", multi[0], multi_p[0], True),
            ("ell_multi", multi[1], multi_p[1], True),
            ("ell_multi", multi[2], multi_p[2], False),
            ("ell_triangles",
             neighbor_common_ell(rows, nbr_rows, K=ex.field_bound, deg=deg),
             neighbor_common_ell_plain(rows, nbr_rows, ex.field_bound),
             True)):
        torch.cuda.synchronize()
        e = float((got.double() - want.double()).abs().max())
        ok = e == 0 if exact else torch.allclose(got, want, **SUM_TOL)
        if not ok:
            raise AssertionError(f"{what}: {name} differs from plain on the "
                                 f"executor's field by {e}")
        err[name] = max(err.get(name, 0), e)
    return err


def mesh_programs_phase(g, core, ups, skew):
    """mesh_programs_ds1, inside mesh_ds1's one-rank NCCL group: the mesh
    programs (`runtime.spmd.SpmdEngine`) and the stream on the mesh.

    Through ONE `SpmdExecutor` of DS1: CC, PageRank (30 fixed supersteps,
    and tol = 1e-6), triangles, `fused_analytics` warm-started from the
    coreness and labels, and `coreness_via_spmd` (its traces' W2W equal to
    `coreness_via_engine`'s metering); then DS1's 200 updates through a
    `StreamSession(backend="ell_spmd", cc_labels=)`, snapshotted after
    window 12, restored by `restore_session(backend="ell_spmd")` and
    streamed on; and mirrored coreness on skew_egofb's split graph.  Each
    equals the single-device "ell" run (integers, superstep counts, graph
    arrays, `StreamStats` but the plan counters, bit for bit; ranks at
    RANK_TOL), the restored stream the uninterrupted one (every field).
    `ell_hindex`, `ell_frontier`, `ell_cc`, `ell_pagerank`, `ell_multi`
    and `ell_triangles` must launch; then the four combine kernels are
    held against their plain versions on the executor's field.  Prints
    host ms a superstep (CC, the mirrored coreness) and a window (the
    stream) against "ell".  Returns (launches, parity errors)."""
    import tempfile
    import torch
    from repro_torch.checkpoint import (
        CheckpointManager, restore_session, save_session)
    from repro_torch.core import (
        connected_components, coreness, coreness_via_engine,
        coreness_via_spmd, fused_analytics, pagerank, triangle_counts)
    from repro_torch.runtime import SpmdExecutor, StreamSession

    from repro_torch.core.algorithms import CorenessBlockProgram
    from repro_torch.kernels import ops

    what = "mesh_programs_ds1"
    labels0 = connected_components(g, backend="ell")
    names = ("ell_hindex", "ell_frontier", "ell_cc", "ell_pagerank",
             "ell_multi", "ell_triangles")
    windows = [ups[i:i + R] for i in range(0, len(ups), R)]
    cut = 12  # windows before the snapshot
    _, g2, plan, _ = skew

    def walled(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    def analytics(backend, ex=None):
        kw = dict(backend=backend, executor=ex)
        r = {}
        (r["labels"], r["cc_steps"]), r["cc_s"] = walled(
            lambda: connected_components(g, with_steps=True, **kw))
        r["rank"], r["pr_steps"] = pagerank(g, tol=None, max_steps=30,
                                            with_steps=True, **kw)
        r["rank_tol"], r["pr_tol_steps"] = pagerank(g, tol=1e-6,
                                                    with_steps=True, **kw)
        r["tri"], r["tri_steps"] = triangle_counts(g, with_steps=True, **kw)
        r["fused"] = fused_analytics(g, steps=30, init=(core, r["labels"]),
                                     **kw)
        return r

    def stream(backend, tmp=None):
        sess = StreamSession(g.clone(), core.clone(), R=R, backend=backend,
                             cc_labels=labels0.clone())
        t = []
        for i, w in enumerate(windows):
            if tmp is not None and i == cut:
                mgr = CheckpointManager(tmp)
                save_session(mgr, sess)
                _, back, _ = restore_session(mgr, backend=backend,
                                             device=g.device)
                for w2 in windows[cut:]:
                    back.apply_window(w2)
            _, s = walled(lambda: sess.apply_window(w))
            t.append(s)
        return sess, (back if tmp is not None else None), t

    def mesh_path(tmp):
        ex = SpmdExecutor(g)
        r = analytics("ell_spmd", ex)
        (r["via_core"], r["via_eng"]), r["via_s"] = walled(
            lambda: coreness_via_spmd(g))
        r["sess"], r["back"], r["win_s"] = stream("ell_spmd", tmp)
        (r["m_core"], r["m_steps"]), r["m_s"] = walled(
            lambda: ops.run_block_program(g2, CorenessBlockProgram(),
                                          backend="ell_spmd", mirror=plan,
                                          with_steps=True))
        r["ex"] = ex
        return r

    with tempfile.TemporaryDirectory() as tmp:
        m, counts = _counted(lambda: mesh_path(tmp), names)
    e = analytics("ell")
    e["sess"], _, e["win_s"] = stream("ell")
    (e["m_core"], e["m_steps"]), e["m_s"] = walled(
        lambda: ops.run_block_program(g2, CorenessBlockProgram(),
                                      backend="ell", mirror=plan,
                                      with_steps=True))
    via_core, via_eng = coreness_via_engine(g, backend="ell")
    st, est, bst = m["sess"].stats(), e["sess"].stats(), m["back"].stats()
    no_plan = dict(plan_updates=0, plan_rebuilds=0)
    checks = {
        "cc": torch.equal(m["labels"], e["labels"])
        and m["cc_steps"] == e["cc_steps"],
        "pagerank": m["pr_steps"] == e["pr_steps"] == 30
        and torch.allclose(m["rank"], e["rank"], **RANK_TOL),
        "pagerank_tol": m["pr_tol_steps"] == e["pr_tol_steps"]
        and torch.allclose(m["rank_tol"], e["rank_tol"], **RANK_TOL),
        "triangles": torch.equal(m["tri"], e["tri"])
        and m["tri_steps"] == e["tri_steps"] == 1,
        "fused": torch.equal(m["fused"][0], e["fused"][0])
        and torch.equal(m["fused"][1], e["fused"][1])
        and torch.allclose(m["fused"][2], e["fused"][2], **RANK_TOL),
        "coreness_via_spmd": torch.equal(m["via_core"], via_core)
        and torch.equal(m["via_core"], core)
        and len(m["via_eng"].traces) == len(via_eng.traces)
        and m["via_eng"].message_totals()[2:]
        == via_eng.message_totals()[2:],
        "stream": torch.equal(m["sess"].core, e["sess"].core)
        and torch.equal(m["sess"].g.nbr, e["sess"].g.nbr)
        and torch.equal(m["sess"].labels, e["sess"].labels)
        and st._replace(**no_plan) == est and st.plan_updates > 0,
        "restored": torch.equal(m["back"].core, m["sess"].core)
        and torch.equal(m["back"].g.nbr, m["sess"].g.nbr)
        and torch.equal(m["back"].labels, m["sess"].labels) and bst == st,
        "mirrored_coreness": torch.equal(m["m_core"], e["m_core"])
        and m["m_steps"] == e["m_steps"]
        and torch.equal(torch.where(g2.node_mask, m["m_core"], 0),
                        coreness(g2, backend="ell", mirror=plan)),
        "one_executor": m["ex"].plan_updates == m["ex"].full_rebuilds == 0,
    }
    if not all(checks.values()):
        raise AssertionError(f"{what}: differs from single-device ell: "
                             f"{checks}; {st} vs {est}")
    err = _mesh_field_parity(m["ex"], g, m["labels"], m["rank"])
    steps_m = len(m["via_eng"].traces)

    def per(n, s):
        return s * 1e3 / max(1, n)

    emit(phase=what, W=m["ex"].wm.W, N=g.N, cc_steps=m["cc_steps"],
         pr_tol_steps=m["pr_tol_steps"], via_spmd_steps=steps_m,
         via_spmd_totals=m["via_eng"].message_totals()._asdict(),
         stream_stats=st._asdict(), snapshot_at_window=cut,
         rank_max_abs_err=float((m["rank"] - e["rank"]).abs().max()),
         launches=counts,
         cc_host_ms_per_superstep={"ell_spmd": per(m["cc_steps"], m["cc_s"]),
                                   "ell": per(e["cc_steps"], e["cc_s"])},
         stream_host_ms_per_window={
             "ell_spmd": statistics.median(m["win_s"]) * 1e3,
             "ell": statistics.median(e["win_s"]) * 1e3},
         stream_host_seconds={"ell_spmd": sum(m["win_s"]),
                              "ell": sum(e["win_s"])},
         mirrored_coreness_steps=m["m_steps"],
         mirrored_coreness_host_ms_per_superstep={
             "ell_spmd": per(m["m_steps"], m["m_s"]),
             "ell": per(e["m_steps"], e["m_s"])},
         max_abs_err=err)
    return counts, err


def recovery_phase(g, core, ups):
    """recovery_ds1: an `ElasticCoordinator` over DS1's 200 updates (R = 8,
    "ell") with a checkpoint before window 10; the session is killed
    before window 18 (a read of it must raise), block 3 is lost (one block
    per worker, W_old = P), recovered (restore, evacuation, replay of the
    log tail) and the stream goes on.  The final graph and coreness equal
    a never-crashed oracle's logical state (coreness and edges by original
    id) and a fresh recompute; the `StreamStats` equal the same drill's on
    the plain backend, and count the oracle's updates and windows.
    Prints the host seconds of the restore, the evacuation (its moves and
    grows) and the replay (its entries).  Returns the launches."""
    import tempfile
    import numpy as np
    import torch
    import repro_torch.checkpoint as ckpt
    from repro_torch.core import coreness, to_networkx_edges
    from repro_torch.runtime import StreamSession
    from repro_torch.runtime import recovery as rec

    what = "recovery_ds1"
    CKPT_AT, KILL_AT, DEAD, P = 10, 18, 3, g.P
    windows = [ups[i:i + R] for i in range(0, len(ups), R)]

    def drill(backend):
        with tempfile.TemporaryDirectory() as d:
            sess = StreamSession(g.clone(), core.clone(), R=R,
                                 backend=backend)
            coord = rec.ElasticCoordinator(sess, ckpt.CheckpointManager(d))
            info = {}
            for i, w in enumerate(windows):
                if i == CKPT_AT:
                    coord.checkpoint()
                if i == KILL_AT:
                    dead = coord.session
                    grows0 = dead._grows
                    with _host_timed(ckpt, ("restore_session",)) as t_res, \
                            _host_timed(rec, ("evacuate_blocks",)) as t_ev, \
                            _host_timed(rec.WindowLog, ("replay",)) as t_rp:
                        coord.recover_worker(DEAD, W_old=P)
                    try:
                        dead.core.cpu()
                    except RuntimeError:
                        pass
                    else:
                        raise AssertionError(f"{what}: a read of the killed "
                                             "session did not raise")
                    st = coord.session.stats()
                    info = dict(
                        restore_seconds=t_res["restore_session"],
                        evacuate_seconds=t_ev["evacuate_blocks"],
                        moves=st.migrated_vertices,
                        grows=coord.session._grows - grows0,
                        replay_seconds=t_rp["replay"],
                        replayed_entries=KILL_AT - CKPT_AT,
                        log_entries=len(coord.log))
                coord.apply_window(w)
            torch.cuda.synchronize()
            return coord.session, info

    t0 = time.perf_counter()
    (sess, info), counts = _counted(lambda: drill("ell"))
    secs = time.perf_counter() - t0
    plain, _ = drill("torch")
    oracle = StreamSession(g.clone(), core.clone(), R=R, backend="ell")
    for w in windows:
        oracle.apply_window(w)

    def by_orig(s):
        orig, c = s.g.orig_id.cpu().numpy(), s.core.cpu().numpy()
        out = np.full(int(orig.max()) + 1, -1, c.dtype)
        out[orig[orig >= 0]] = c[orig >= 0]
        return out

    st, ost = sess.stats(), oracle.stats()
    mask = sess.g.node_mask.view(P, sess.g.Cn)
    checks = {
        "plain": (torch.equal(sess.core, plain.core)
                  and torch.equal(sess.g.nbr, plain.g.nbr)
                  and st == plain.stats()),
        "oracle_core": np.array_equal(by_orig(sess), by_orig(oracle)),
        "oracle_edges": np.array_equal(to_networkx_edges(sess.g),
                                       to_networkx_edges(oracle.g)),
        "recompute": torch.equal(sess.core, coreness(sess.g,
                                                     backend="torch")),
        "counts": (st.updates, st.batches) == (ost.updates, ost.batches)
        and st.migrations == ost.migrations + 1,
        "evacuated": not bool(mask[DEAD].any()),
    }
    if not all(checks.values()):
        raise AssertionError(f"{what}: {checks}; {st} vs oracle {ost}")
    emit(phase=what, windows=len(windows), checkpoint_at=CKPT_AT,
         killed_at=KILL_AT, dead_block=DEAD, N=sess.g.N, Cn=sess.g.Cn,
         stream_stats=st._asdict(), oracle_stats=ost._asdict(),
         launches=counts, path_seconds=secs, **info)
    return counts


def _audit_world(world, what):
    """Every manifest entry on `world`, each with the kernels' launch
    counts set to 0 just before and read just after; one line each.
    Raises on any finding.  Returns the launches summed over the
    entries."""
    import torch
    from repro_torch.analysis import entrypoints as audit

    total = {name: 0 for name in KERNELS}
    failed = []
    for ep in audit.MANIFEST:
        for name in KERNELS:
            _wrapper(name).launches = 0
        res = audit.audit_entry(ep, world)
        torch.cuda.synchronize()
        counts = {name: _wrapper(name).launches for name in KERNELS}
        for name, c in counts.items():
            total[name] += c
        emit(phase=what, graph=world.name, entry=ep.name,
             host_reads=res.host_reads, cuda_syncs=res.cuda_syncs,
             read_budget=res.read_budget, sync_budget=res.sync_budget,
             reference_budget=ep.reference_budget, steps=res.steps,
             ms=res.ms, probe=res.probe, error=res.error,
             launches={n: c for n, c in counts.items() if c},
             read_sites=res.read_sites, sync_sites=res.sync_sites)
        failed += [str(f) for f in res.findings(ep)]
    if failed:
        raise AssertionError(f"{what} on {world.name}: " + "\n".join(failed))
    return total


def audit_phase(g, ups, dev):
    """audit_ds1: the port's tracelint on the checkout (its CLI with
    ``--check``, the static part), then the manifest on the tiny graph and
    on DS1, every count within its budget.  Returns the kernels' launches
    on DS1."""
    from repro_torch.analysis import entrypoints as audit
    from repro_torch.analysis.__main__ import main as tracelint

    what = "audit_ds1"
    t0 = time.perf_counter()
    rc = tracelint(["--check", "--no-audit"])
    if rc != 0:
        raise AssertionError(f"{what}: tracelint --check exited {rc}")
    lint_seconds = time.perf_counter() - t0
    _audit_world(audit.tiny_world(dev), what)
    window = audit.clean_window(g, ups, R)
    if window is None:
        raise AssertionError(f"{what}: no window of the DS1 stream routes "
                             "clean")
    window, escalated = ([tuple(int(x) for x in u) for u in w]
                         for w in (window, ups[:R]))
    world = audit.World(g.clone(), window, R=R, name="ds1",
                        escalated=escalated)
    counts = _audit_world(world, what)
    missing = [k for k in AUDIT_KERNELS if counts[k] < 1]
    if missing:
        raise AssertionError(f"{what}: {missing} never launched on DS1")
    emit(phase=what, lint_seconds=lint_seconds, window=window,
         escalated=escalated, launches=counts,
         seconds=time.perf_counter() - t0)
    return counts


#: serve_lm: the LM substrate's serve path at published widths in bf16,
#: all ten architectures of `configs/`
SERVE_MODELS = ("internlm2-1.8b", "gemma3-1b", "deepseek-v3-671b",
                "llama4-scout-17b-a16e", "mamba2-370m", "zamba2-7b",
                "codeqwen1.5-7b", "granite-34b", "paligemma-3b",
                "seamless-m4t-large-v2")
#: layers held on the card where the published depth does not fit it
#: (671.0e9, 107.8e9 and 47.25e9 parameters): deepseek's 3 dense MLA
#: layers and 2 MoE layers (23.0 GB each in bf16), llama4's first 12 of
#: 48 (4.4 GB each), granite's first 52 of 88 (1.07 GB each: 28.2e9
#: parameters, 56.3 GB, leaving room for the prompts' activations and
#: the check's forward); every width as published
SERVE_DEPTH = {"deepseek-v3-671b": 5, "llama4-scout-17b-a16e": 12,
               "granite-34b": 52}
SERVE_BATCH = 4          # prompts served together
SERVE_PROMPT = 1024      # tokens a prompt; gemma3: 2 windows of 512
SERVE_STEPS = 32         # greedy decode steps after the prompt
SERVE_SEED = 0           # parameters; SERVE_SEED + 1 the prompts
SERVE_RING_STEPS = 576   # gemma3 ring vs full caches: window + 64 steps
#: check (a) of the MoE and mamba models: decode against the forward on
#: the first SERVE_CHECK_PROMPT tokens of each prompt and SERVE_STEPS
#: greedy steps (MoE on the dense path, whose decode and forward keep the
#: same tokens; a mamba cache is built one token at a time)
SERVE_CHECK_PROMPT = 64
#: check (g): (B, S) tokens through one MoE layer, capacity T·k vs dense
SERVE_MOE_TOKENS = (4, 16)
#: bf16 logits against another bf16 route to the same logits (decode vs
#: forward, banded vs masked, ring vs full), relative to the largest
#: |logit|: bf16 keeps 8 bits, and the two routes round at other points
SERVE_BF16_TOL = 5e-2
#: (a) of the mamba models (mamba2, zamba2): token-by-token decode
#: against the chunked forward in bf16.  The reference's two forms round
#: bf16 at other points in each of 48 (81) layers — `_causal_conv` and
#: its silu in bf16 in the chunked form, in float32 in `mamba_step` —
#: and measured 6.46e-2 and 6.89e-2 (mamba2), 7.92e-2 and 8.65e-2
#: (zamba2) on the H100 against 5.9e-6 and 1.1e-5 in float32 with the
#: same weights (PERF.md, PR 25; `tools/serve_lm.py --f32-check`)
SERVE_BF16_SSM_TOL = 0.15
#: float32 logits of a reduced config, card against CPU, same parameters
SERVE_F32_TOL = 1e-4


def _rel_err(got, want) -> float:
    """max |got - want| over max |want|, taken one leading row at a time
    (a model's logits at full vocabulary are GBs in float32)."""
    num = max(float((g.float() - w.float()).abs().max())
              for g, w in zip(got, want))
    den = max(float(w.float().abs().max()) for w in want)
    return num / den


def _all_finite(what, *tensors) -> None:
    import torch

    for t in tensors:
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{what}: a logit is not finite")


def _serve_config(name):
    """(the config served, its `reduced` record: depth cuts only)."""
    from repro_torch.configs import get_arch

    cfg = get_arch(name)
    if name not in SERVE_DEPTH:
        return cfg, {}
    return (dataclasses.replace(cfg, n_layers=SERVE_DEPTH[name]),
            {"n_layers": [cfg.n_layers, SERVE_DEPTH[name]]})


def _prefill(b, params, prompts, caches, block, **kw):
    """The prompts into `caches` through `decode_fn`, `block` positions a
    call (the whole prompt; 1 for a mamba cache).  Returns (the prompt's
    logits, seconds)."""
    import torch

    S = prompts.shape[1]
    t0 = time.perf_counter()
    pre = []
    for s0 in range(0, S, block):
        lg, caches = b.decode_fn(params, prompts[:, s0:s0 + block], caches,
                                 s0, **kw)
        pre.append(lg)
    pre = pre[0] if len(pre) == 1 else torch.cat(pre, dim=1)
    torch.cuda.synchronize()
    return pre, time.perf_counter() - t0


def _decode(b, params, last, caches, pos, G, feed=None, **kw):
    """G greedy decode steps from the logits `last` at position `pos` (or
    the tokens `feed`, `last` then unread).  Returns (each step's logits,
    the fed tokens, each step's ms)."""
    import torch

    tok = None if feed is not None else \
        torch.argmax(last[:, -1], dim=-1)[:, None]
    fed, outs, step_ms = [], [], []
    for i in range(G):
        t0 = time.perf_counter()
        if feed is not None:
            tok = feed[i]
        fed.append(tok)
        lg, caches = b.decode_fn(params, tok, caches, pos + i, **kw)
        tok = torch.argmax(lg[:, -1], dim=-1)[:, None]
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        outs.append(lg)
    return outs, fed, step_ms


def _flips(a_calls, b_calls) -> int:
    """Tokens routed to another expert set, router call by router call
    (each call's (T, k) ids; equal T in both runs)."""
    return sum(int((x.sort(-1).values != y.sort(-1).values).any(-1).sum())
               for x, y in zip(a_calls, b_calls))


def _per_layer(dec_calls, n_moe, B):
    """A served sequence's router calls (a prompt block, then one token a
    step: `n_moe` calls each) as one (B·S, k) call a MoE layer, in the
    forward's token order."""
    import torch

    k = dec_calls[0].shape[-1]
    calls = [dec_calls[i:i + n_moe] for i in range(0, len(dec_calls), n_moe)]
    return [torch.cat([c[l].reshape(B, -1, k) for c in calls],
                      dim=1).reshape(-1, k) for l in range(n_moe)]


def _routes_of(fn, replay=None):
    """(fn()'s result, the expert ids its router calls picked).  With
    `replay` (one (T, k) id tensor a router call), each call takes those
    ids instead, weighted by its own renormalised probabilities: two runs
    that round bf16 at other points then agree on which experts serve
    each token, and differ only by that rounding."""
    import torch
    from repro_torch.models import moe

    own = []
    real = moe._router
    todo = iter(replay) if replay is not None else None

    def router(p, cfg, x):
        topv, topi, aux = real(p, cfg, x)
        own.append(topi)
        if todo is None:
            return topv, topi, aux
        ids = next(todo)
        probs = torch.softmax(x.float() @ p["router"]["w"].float(), dim=-1)
        w = probs.gather(1, ids)
        return w / w.sum(-1, keepdim=True), ids, aux
    moe._router = router
    try:
        out = fn()
    finally:
        moe._router = real
    return out, own


def _check_decode(b, params, prompts, dev, replay=True):
    """(a) of a MoE or mamba model: SERVE_CHECK_PROMPT tokens of each
    prompt into a fresh cache (a block; a mamba cache one token a step)
    and SERVE_STEPS greedy steps, against the forward over the same
    tokens, MoE layers on the dense path and, with `replay`, the
    forward's routers picking the experts the decode picked.  Returns
    (error, tokens whose forward router picked other experts)."""
    import torch
    from repro_torch.models import transformer

    B, P, G = prompts.shape[0], SERVE_CHECK_PROMPT, SERVE_STEPS
    n_moe = sum(blk.count for blk in transformer.layer_plan(b.cfg)
                if blk.moe)
    block = 1 if b.cfg.mixer == "mamba" else P
    caches = b.cache_init(B, P + G, device=dev)

    def serve():
        pre, _ = _prefill(b, params, prompts[:, :P], caches, block,
                          moe_path="dense")
        return (pre,) + _decode(b, params, pre, caches, P, G,
                                moe_path="dense")[:2]
    (pre, outs, fed), dec_routes = _routes_of(serve)
    routes = _per_layer(dec_routes, n_moe, B) if n_moe else []
    seq = torch.cat([prompts[:, :P]] + fed, dim=1)
    (full, _), fwd_routes = _routes_of(
        lambda: transformer.lm_forward(params, b.cfg, seq, moe_path="dense"),
        routes if replay else None)
    served = torch.cat([pre] + outs, dim=1)
    _all_finite(f"serve_lm[{b.cfg.name}]", served, full)
    return _rel_err(served, full), _flips(fwd_routes, routes)


def _check_absorbed(b, params, pre, snap, fed, pos, replay=True):
    """(h): from the cache `snap` right after the prompt, the served tokens
    `fed` decoded naive and absorbed on the dense MoE path (the
    reference's `test_mla_absorbed_equals_naive`; with `replay`, the
    absorbed run's routers pick the naive run's experts), and absorbed on
    the serving (capacity) path, timed.  Returns (error of absorbed
    against naive, tokens whose absorbed router picked other experts,
    the absorbed serving steps' ms)."""
    import torch
    from repro_torch.models.scan_util import tree_map

    G = len(fed)
    (naive, _, _), r_naive = _routes_of(lambda: _decode(
        b, params, pre, tree_map(torch.clone, snap), pos, G, feed=fed,
        moe_path="dense"))
    (absorbed, _, _), r_abs = _routes_of(lambda: _decode(
        b, params, pre, tree_map(torch.clone, snap), pos, G, feed=fed,
        moe_path="dense", mla_absorbed=True), r_naive if replay else None)
    served, _, ms = _decode(b, params, pre, snap, pos, G, feed=fed,
                            mla_absorbed=True)
    _all_finite(f"serve_lm[{b.cfg.name}]", *naive, *absorbed, *served)
    return (_rel_err(torch.cat(absorbed, dim=1), torch.cat(naive, dim=1)),
            _flips(r_abs, r_naive), ms)


def _moe_layer_check(params, cfg, dev):
    """(g): the first MoE layer at full width, `moe_capacity` with
    capacity T·k (nothing dropped) against `moe_dense`."""
    import torch
    from repro_torch.models import moe
    from repro_torch.models.scan_util import tree_map

    p = tree_map(lambda t: t[0], params["blocks"][-1]["moe"])
    gen = torch.Generator(device=dev)
    gen.manual_seed(SERVE_SEED + 2)
    x = torch.randn(SERVE_MOE_TOKENS + (cfg.d_model,), generator=gen,
                    device=dev).to(torch.bfloat16)
    T = x.shape[0] * x.shape[1]
    yd, _ = moe.moe_dense(p, cfg, x)
    yc, _ = moe.moe_capacity(p, cfg, x, capacity=T * cfg.top_k)
    _all_finite("serve_lm: moe layer", yd, yc)
    return _rel_err(yc, yd)


def _shared_block_check(b, params, prompts, dev):
    """(i): zamba2's shared block is one parameter set: every period of a
    forward and of a decode step applies the tensors at the data_ptrs of
    `params["shared_block"]`."""
    from repro_torch.models import transformer
    from repro_torch.models.scan_util import tree_leaves

    want = [t.data_ptr() for t in tree_leaves(params["shared_block"])]
    seen = []
    real = transformer._apply_shared_block

    def shared_block(p, *a, **k):
        seen.append([t.data_ptr() for t in tree_leaves(p)])
        return real(p, *a, **k)
    transformer._apply_shared_block = shared_block
    try:
        b.prefill_fn(params, {"tokens": prompts[:, :16]}, last_only=True)
        caches = b.cache_init(prompts.shape[0], 1, device=dev)
        b.decode_fn(params, prompts[:, :1], caches, 0)
    finally:
        transformer._apply_shared_block = real
    periods = transformer.layer_plan(b.cfg)[0].count
    if len(seen) != 2 * periods or any(s != want for s in seen):
        raise AssertionError(
            f"serve_lm[{b.cfg.name}]: the shared block ran {len(seen)} "
            f"times in a forward and a step ({2 * periods} wanted), "
            f"{sum(s != want for s in seen)} of them on other tensors")
    return {"shared_block_calls": len(seen),
            "shared_block_data_ptrs": len(set(map(tuple, seen)))}


def _tree_bytes(tree) -> int:
    from repro_torch.models.scan_util import tree_leaves

    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def _serve_model(name, card, dev):
    """One model of serve_lm: parameters drawn on the card, the prompts
    served (a block prefill into a full cache and SERVE_STEPS greedy
    steps; a mamba model times its chunked `prefill_fn` and decodes after
    a token-by-token cache build), then the model's checks."""
    import torch
    from repro_torch.models import build, layers, moe, param_count
    from repro_torch.models import transformer
    from repro_torch.models.scan_util import tree_map

    what = f"serve_lm[{name}]"
    cfg, reduced = _serve_config(name)
    b = build(cfg)
    mamba = cfg.mixer == "mamba"
    n_moe = sum(blk.count for blk in transformer.layer_plan(cfg) if blk.moe)
    B, S, G = SERVE_BATCH, SERVE_PROMPT, SERVE_STEPS
    t0 = time.perf_counter()
    params = b.init(SERVE_SEED, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = param_count(params)
    param_bytes = _tree_bytes(params)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SERVE_SEED + 1)
    prompts = torch.randint(0, cfg.vocab, (B, S), generator=gen, device=dev)
    # a prefix-LM's stub patch embeddings (paligemma: 256 of width 1152),
    # prefilled at position 0 with the prompts; decode starts at P + S
    P = cfg.n_prefix_tokens
    extra = {"prefix_embeds": torch.randn((B, P, cfg.prefix_dim),
                                          generator=gen, device=dev)} \
        if P else {}
    line = dict(phase="serve_lm", model=name, reduced=reduced,
                layers=cfg.n_layers, params=n_params, param_bytes=param_bytes,
                batch=B, prompt=S, decode_steps=G, init_s=init_s)
    if P:
        line.update(prefix_tokens=P, prefix_dim=cfg.prefix_dim)
    errs, flips = {}, {}

    if mamba:
        # the serving forward: the chunked scan over the whole prompts
        b.prefill_fn(params, {"tokens": prompts}, last_only=True)  # warm-up
        torch.cuda.synchronize()
        start_bytes = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        last, _ = b.prefill_fn(params, {"tokens": prompts}, last_only=True)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        # decode: the cache built one token a step, then greedy steps
        P = SERVE_CHECK_PROMPT
        caches = b.cache_init(B, P + G, device=dev)
        pre, build_s = _prefill(b, params, prompts[:, :P], caches, 1)
        outs, fed, step_ms = _decode(b, params, pre, caches, P, G)
        serve_peak = torch.cuda.max_memory_allocated()
        cache_bytes = _tree_bytes(caches)
        served = torch.cat([pre] + outs, dim=1)
        _all_finite(what, served, last)
        line.update(prefill_s=prefill_s, prefill_tok_s=B * S / prefill_s,
                    prefill_form="prefill_fn(last_only=True), chunked scan",
                    cache_prompt=P, cache_build_s=build_s)
        # (a) the token-by-token decode against the forward
        seq = torch.cat([prompts[:, :P]] + fed, dim=1)
        full, _ = b.prefill_fn(params, {"tokens": seq})
        _all_finite(what, full)
        errs["decode_vs_forward"] = _rel_err(served, full)
        del served, full
        full_p, _ = b.prefill_fn(params, {"tokens": prompts})
        _all_finite(what, full_p)
        errs["last_only"] = _rel_err(last, full_p[:, -1:])
        del full_p
        if cfg.shared_attn_period:
            line.update(_shared_block_check(b, params, prompts, dev))
    else:
        _prefill(b, params, prompts, b.cache_init(B, P + S + G, device=dev),
                 S, **extra)  # warm-up
        torch.cuda.synchronize()
        start_bytes = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        caches = b.cache_init(B, P + S + G, device=dev)
        pre, prefill_s = _prefill(b, params, prompts, caches, S, **extra)
        snap = (tree_map(torch.clone, caches)
                if cfg.attn_impl == "mla" else None)
        outs, fed, step_ms = _decode(b, params, pre, caches, P + S, G)
        serve_peak = torch.cuda.max_memory_allocated()
        cache_bytes = _tree_bytes(caches)
        served = torch.cat([pre] + outs, dim=1)
        _all_finite(what, served)
        line.update(prefill_s=prefill_s, prefill_tok_s=B * S / prefill_s)
        del outs, caches
        if snap is not None:
            # (h) the absorbed decode against the naive one
            err, n, a_ms = _check_absorbed(b, params, pre, snap, fed, S)
            errs["absorbed_vs_naive"], flips["absorbed_vs_naive"] = err, n
            line.update(absorbed_decode_ms=statistics.median(a_ms),
                        absorbed_decode_ms_min=min(a_ms),
                        absorbed_decode_ms_max=max(a_ms),
                        absorbed_check_moe_path="dense",
                        absorbed_check_routes="replayed")
            del snap
        del pre
        if n_moe:
            # (a) on the dense path: decode against the forward
            err, n = _check_decode(b, params, prompts, dev)
            errs["decode_vs_forward"], flips["decode_vs_forward"] = err, n
            line.update(check_prompt=SERVE_CHECK_PROMPT,
                        check_moe_path="dense", check_routes="replayed")
            # (g) one MoE layer: capacity T·k against dense
            errs["moe_capacity_vs_dense"] = _moe_layer_check(params, cfg,
                                                             dev)
        else:
            # (a) block prefill + decode against the forward, same tokens
            seq = torch.cat([prompts] + fed, dim=1)
            full, _ = b.prefill_fn(params, {"tokens": seq, **extra})
            _all_finite(what, full)
            errs["decode_vs_forward"] = _rel_err(served, full)
            del full
        del served
        # (b) the serving forward's last_only logits against the last row
        banded = []
        real_banded = layers.sdpa_banded
        layers.sdpa_banded = lambda *a, **k: banded.append(1) or \
            real_banded(*a, **k)
        try:
            full_p, _ = b.prefill_fn(params, {"tokens": prompts, **extra})
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            last, _ = b.prefill_fn(params, {"tokens": prompts, **extra},
                                   last_only=True)
            torch.cuda.synchronize()
            last_s = time.perf_counter() - t0
        finally:
            layers.sdpa_banded = real_banded
        _all_finite(what, full_p, last)
        errs["last_only"] = _rel_err(last, full_p[:, -1:])
        del full_p
        line.update(prefill_fn_last_only_s=last_s,
                    banded_calls=len(banded) // 2)

    decode_ms = statistics.median(step_ms)
    line.update(decode_ms=decode_ms, decode_ms_min=min(step_ms),
                decode_ms_max=max(step_ms),
                decode_tok_s=B / (decode_ms / 1e3),
                decode_bound_ms=param_bytes / HBM_BYTES_PER_S * 1e3,
                decode_bound_ms_with_cache=(param_bytes + cache_bytes)
                / HBM_BYTES_PER_S * 1e3,
                cache_bytes_served=cache_bytes,
                serve_peak_bytes=serve_peak, start_bytes=start_bytes)
    if n_moe:
        # a dispatch reading only the chosen experts: at most B·k of E
        E, k = cfg.n_experts, cfg.top_k
        expert_bytes = 3 * cfg.d_model * cfg.moe_d_ff * 2
        active = param_bytes - n_moe * (E - min(E, B * k)) * expert_bytes
        line.update(active_param_bytes=active,
                    decode_active_bound_ms=active / HBM_BYTES_PER_S * 1e3,
                    route_flips=flips)
    if cfg.sliding_window:
        # (c) the banded prefill against the masked-full one
        local = cfg.n_layers - cfg.n_layers // cfg.local_global_period
        if len(banded) != 2 * local:
            raise AssertionError(f"{what}: the banded path ran "
                                 f"{len(banded)} times in 2 forwards")
        old = os.environ.get("REPRO_NO_BANDED")
        os.environ["REPRO_NO_BANDED"] = "1"
        try:
            masked, _ = b.prefill_fn(params, {"tokens": prompts},
                                     last_only=True)
        finally:
            if old is None:
                del os.environ["REPRO_NO_BANDED"]
            else:
                os.environ["REPRO_NO_BANDED"] = old
        _all_finite(what, masked)
        errs["banded_vs_masked"] = _rel_err(last, masked)
        # (d) ring and full caches, token by token past the window
        T = SERVE_RING_STEPS
        ring = b.cache_init(B, T, ring=True, device=dev)
        flat = b.cache_init(B, T, device=dev)
        cache_bytes = {"ring": _tree_bytes(ring), "full": _tree_bytes(flat)}
        num = torch.zeros((), device=dev)
        den = torch.zeros((), device=dev)
        bad = torch.zeros((), dtype=torch.bool, device=dev)
        ring_ms = []
        for t in range(T):
            t0 = time.perf_counter()
            lr, ring = b.decode_fn(params, prompts[:, t:t + 1], ring, t)
            torch.cuda.synchronize()
            ring_ms.append((time.perf_counter() - t0) * 1e3)
            lf, flat = b.decode_fn(params, prompts[:, t:t + 1], flat, t)
            num = torch.maximum(num, (lr.float() - lf.float()).abs().max())
            den = torch.maximum(den, lf.float().abs().max())
            bad |= ~(torch.isfinite(lr).all() & torch.isfinite(lf).all())
        if bool(bad):
            raise AssertionError(f"{what}: a ring or full logit is not "
                                 "finite")
        errs["ring_vs_full"] = float(num / den)
        line.update(ring_steps=T, ring_decode_ms=statistics.median(ring_ms),
                    cache_bytes=cache_bytes)
    tols = {k: SERVE_BF16_TOL for k in errs}
    if mamba:
        tols["decode_vs_forward"] = SERVE_BF16_SSM_TOL
        line.update(tol_decode_vs_forward=SERVE_BF16_SSM_TOL)
    line.update(errors=errs, tol=SERVE_BF16_TOL, card=card)
    emit(**line)
    over = {k: e for k, e in errs.items() if not e <= tols[k]}
    if over:
        raise AssertionError(f"{what}: {over} above {tols}")


def _serve_cpu_parity(name, dev):
    """(e): the reduced float32 config on the card against the CPU, same
    parameters: the forward, the prompt into the cache (a block of 44,
    with a prefix-LM's stub embeddings; a mamba model's cache one token a
    step) and 4 decode steps."""
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import build
    from repro_torch.models.scan_util import tree_map

    b = build(get_arch(name).reduced())
    block = 1 if b.cfg.mixer == "mamba" else 44
    cpu = torch.device("cpu")
    params = b.init(SERVE_SEED, device=cpu)
    on_card = tree_map(lambda t: t.to(dev), params)
    rng = np.random.default_rng(SERVE_SEED)
    toks = torch.from_numpy(rng.integers(0, b.cfg.vocab, (2, 48)))
    # a prefix-LM's stub embeddings go in with the first block
    P = b.cfg.n_prefix_tokens
    pfx = torch.from_numpy(rng.standard_normal(
        (2, P, b.cfg.prefix_dim)).astype(np.float32)) if P else None
    kc = {"prefix_embeds": pfx} if P else {}
    kd = {"prefix_embeds": pfx.to(dev)} if P else {}
    err = 0.0
    want, _ = b.prefill_fn(params, {"tokens": toks, **kc})
    got, _ = b.prefill_fn(on_card, {"tokens": toks.to(dev), **kd})
    err = max(err, _rel_err(got.cpu(), want))
    cc = b.cache_init(2, P + 48, device=cpu)
    cd = b.cache_init(2, P + 48, device=dev)
    for s0 in range(0, 44, block):
        first = s0 == 0
        pos = 0 if first else P + s0
        want, cc = b.decode_fn(params, toks[:, s0:s0 + block], cc, pos,
                               **(kc if first else {}))
        got, cd = b.decode_fn(on_card, toks[:, s0:s0 + block].to(dev), cd,
                              pos, **(kd if first else {}))
        err = max(err, _rel_err(got.cpu(), want))
    for t in range(44, 48):
        want, cc = b.decode_fn(params, toks[:, t:t + 1], cc, P + t)
        got, cd = b.decode_fn(on_card, toks[:, t:t + 1].to(dev), cd, P + t)
        err = max(err, _rel_err(got.cpu(), want))
    if not err <= SERVE_F32_TOL:
        raise AssertionError(f"serve_lm[{name}]: card vs CPU {err} above "
                             f"{SERVE_F32_TOL}")
    return err


def _serve_encdec(name, card, dev):
    """serve_lm for the encoder-decoder: parameters drawn on the card,
    SERVE_BATCH sequences of `mem_len` stub frame embeddings through
    `prefill_fn` (the encoder) and `encdec_prime_cross`, both timed; then
    SERVE_CHECK_PROMPT decoder tokens fed one a step and SERVE_STEPS greedy
    steps; (a) the served logits against `encdec_forward` on the fed
    sequence (SERVE_BF16_TOL), (f) every logit finite."""
    import torch
    from repro_torch.models import build, encdec, param_count

    what = f"serve_lm[{name}]"
    cfg, reduced = _serve_config(name)
    b = build(cfg)
    B, Sm, P, G = SERVE_BATCH, cfg.mem_len, SERVE_CHECK_PROMPT, SERVE_STEPS
    t0 = time.perf_counter()
    params = b.init(SERVE_SEED, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    gen = torch.Generator(device=dev)
    gen.manual_seed(SERVE_SEED + 1)
    src = torch.randn((B, Sm, cfg.d_model), generator=gen, device=dev)
    prompts = torch.randint(0, cfg.vocab, (B, P), generator=gen, device=dev)

    def prefill():
        memory, _ = b.prefill_fn(params, {"src_embeds": src})
        torch.cuda.synchronize()
        return memory

    encdec.encdec_prime_cross(params, cfg, prefill(),
                              b.cache_init(B, P + G, device=dev))  # warm-up
    torch.cuda.synchronize()
    start_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    memory = prefill()
    encode_s = time.perf_counter() - t0
    caches = b.cache_init(B, P + G, device=dev)
    t0 = time.perf_counter()
    caches = encdec.encdec_prime_cross(params, cfg, memory, caches)
    torch.cuda.synchronize()
    prime_s = time.perf_counter() - t0
    feed = [prompts[:, i:i + 1] for i in range(P)]
    pre, _, feed_ms = _decode(b, params, None, caches, 0, P, feed=feed)
    outs, fed, step_ms = _decode(b, params, pre[-1], caches, P, G)
    serve_peak = torch.cuda.max_memory_allocated()
    served = torch.cat(pre + outs, dim=1)
    seq = torch.cat([prompts] + fed, dim=1)
    full, _ = encdec.encdec_forward(params, cfg, src, seq)
    _all_finite(what, served, full, memory)
    errs = {"decode_vs_forward": _rel_err(served, full)}
    del served, full
    # a decode step reads the decoder's layers, the final norm and the
    # lm_head, the primed cross K/V and the self caches (one embedding row)
    dec_bytes = _tree_bytes({k: params[k] for k in
                             ("dec", "final_norm", "lm_head")})
    cross_bytes = _tree_bytes(caches["cross"])
    self_bytes = _tree_bytes(caches["self"])
    decode_ms = statistics.median(step_ms)
    emit(phase="serve_lm", model=name, reduced=reduced,
         layers=cfg.n_layers, enc_layers=cfg.enc_layers,
         params=param_count(params), param_bytes=_tree_bytes(params),
         batch=B, frames=Sm, prompt=P, decode_steps=G, init_s=init_s,
         prefill_s=encode_s + prime_s, encode_s=encode_s, prime_s=prime_s,
         encode_frames_s=B * Sm / encode_s,
         prefill_form="prefill_fn (encode) then encdec_prime_cross",
         prompt_feed_ms=statistics.median(feed_ms),
         decode_ms=decode_ms, decode_ms_min=min(step_ms),
         decode_ms_max=max(step_ms), decode_tok_s=B / (decode_ms / 1e3),
         decoder_param_bytes=dec_bytes, cross_cache_bytes=cross_bytes,
         self_cache_bytes=self_bytes,
         decode_bound_ms=(dec_bytes + cross_bytes) / HBM_BYTES_PER_S * 1e3,
         decode_bound_ms_with_cache=(dec_bytes + cross_bytes + self_bytes)
         / HBM_BYTES_PER_S * 1e3,
         serve_peak_bytes=serve_peak, start_bytes=start_bytes,
         errors=errs, tol=SERVE_BF16_TOL, card=card)
    over = {k: e for k, e in errs.items() if not e <= SERVE_BF16_TOL}
    if over:
        raise AssertionError(f"{what}: {over} above {SERVE_BF16_TOL}")


def _encdec_cpu_parity(name, dev):
    """(e) for the encoder-decoder: the reduced float32 config on the card
    against the CPU, same parameters: the forward, the encoder memory and
    8 decode steps against primed cross caches."""
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import build, encdec
    from repro_torch.models.scan_util import tree_map

    b = build(get_arch(name).reduced())
    cpu = torch.device("cpu")
    params = b.init(SERVE_SEED, device=cpu)
    on_card = tree_map(lambda t: t.to(dev), params)
    rng = np.random.default_rng(SERVE_SEED)
    src = torch.from_numpy(rng.standard_normal(
        (2, b.cfg.mem_len, b.cfg.d_model)).astype(np.float32))
    toks = torch.from_numpy(rng.integers(0, b.cfg.vocab, (2, 8)))
    want, _ = encdec.encdec_forward(params, b.cfg, src, toks)
    got, _ = encdec.encdec_forward(on_card, b.cfg, src.to(dev), toks.to(dev))
    err = _rel_err(got.cpu(), want)
    mc, _ = b.prefill_fn(params, {"src_embeds": src})
    md, _ = b.prefill_fn(on_card, {"src_embeds": src.to(dev)})
    err = max(err, _rel_err(md.cpu(), mc))
    cc = encdec.encdec_prime_cross(params, b.cfg, mc,
                                   b.cache_init(2, 8, device=cpu))
    cd = encdec.encdec_prime_cross(on_card, b.cfg, md,
                                   b.cache_init(2, 8, device=dev))
    for t in range(8):
        want, cc = b.decode_fn(params, toks[:, t:t + 1], cc, t)
        got, cd = b.decode_fn(on_card, toks[:, t:t + 1].to(dev), cd, t)
        err = max(err, _rel_err(got.cpu(), want))
    if not err <= SERVE_F32_TOL:
        raise AssertionError(f"serve_lm[{name}]: card vs CPU {err} above "
                             f"{SERVE_F32_TOL}")
    return err


def serve_lm_phase(card, models=SERVE_MODELS):
    """serve_lm (module docstring, phase 15): each of `models` at
    published widths in bf16, then the card against the CPU at float32."""
    import torch
    from repro_torch.configs import get_arch

    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    encdec = {name for name in models if get_arch(name).is_encdec}
    for name in models:
        (_serve_encdec if name in encdec else _serve_model)(name, card, dev)
        torch.cuda.empty_cache()
    cpu_err = {name: (_encdec_cpu_parity if name in encdec
                      else _serve_cpu_parity)(name, dev) for name in models}
    emit(phase="serve_lm", card_vs_cpu_f32=cpu_err, tol=SERVE_F32_TOL,
         seconds=time.perf_counter() - t0)


#: train_parts: training's parts that need no launcher (`repro_torch.optim`,
#: `checkpoint.save_train_state`), on the card
TRAIN_MODEL = "internlm2-1.8b"   # the whole tree, bf16, from SERVE_SEED
TRAIN_GRAD_STD = 1e-3            # seeded bf16 gradients (SERVE_SEED + 3)
TRAIN_REPS = 3                   # timed updates
#: the sampled rows of the full-width update against a float64 host
#: recompute from the same inputs (the card's own clip scale), relative
#: to each leaf's largest |value|: float32 rounds each of the few
#: operations once
TRAIN_TOL = 1e-6
#: ... and the step itself (new master - master, ~3e-4 against masters up
#: to 1.0), in float32 ulps of the leaf's largest |master|: the new
#: master's rounding, half an ulp, and the step's own float32 error
TRAIN_STEP_ULPS = 1.0
#: the float32 global norm over 1.89e9 squares against float64: each
#: leaf's sum is a tree reduction, the leaves are added one by one
TRAIN_NORM_TOL = 1e-5


def _sampled_rows(t, rows):
    """Rows `rows` of `t` seen as (-1, last dim), as float64 on the host."""
    return t.reshape(-1, t.shape[-1])[rows].double().cpu()


def _full_update_check(cfg_opt, grads, state, new_params, new_state, scale):
    """The sampled rows of every leaf of one update from step 0 (a
    zero-warm-up config) against a float64 recompute of AdamW from the
    same rows.  Returns the largest relative error of master, m and v,
    and the step's error in float32 ulps of the largest |master|."""
    import math

    import torch
    from repro_torch.models.scan_util import tree_leaves

    # step 1 of `cosine_lr` without warm-up, in float64
    t = 1 / max(1, cfg_opt.total_steps - cfg_opt.warmup_steps)
    lr = cfg_opt.lr_min + 0.5 * (cfg_opt.lr_peak - cfg_opt.lr_min) * (
        1 + math.cos(math.pi * t))
    b1, b2 = cfg_opt.b1, cfg_opt.b2
    errs = dict(master=0.0, m=0.0, v=0.0, step=0.0)
    gen = torch.Generator()
    gen.manual_seed(SERVE_SEED + 4)
    leaves = zip(*(tree_leaves(x) for x in (
        grads, state.master, state.m, state.v, new_state.master,
        new_state.m, new_state.v, new_params)))
    for g, ma, m0, v0, ma1, m1, v1, p1 in leaves:
        if not torch.equal(p1, ma1.to(p1.dtype)):
            raise AssertionError("train_parts: params are not the new "
                                 "master in the compute dtype")
        n = g.reshape(-1, g.shape[-1]).shape[0]
        rows = torch.tensor(sorted({0, n // 2, n - 1, int(torch.randint(
            n, (1,), generator=gen))}))
        g, ma, m0, v0, ma1, m1, v1 = (_sampled_rows(x, rows) for x in (
            g, ma, m0, v0, ma1, m1, v1))
        gs = g * scale
        m = b1 * m0 + (1 - b1) * gs
        v = b2 * v0 + (1 - b2) * gs * gs
        mhat, vhat = m / (1 - b1), v / (1 - b2)
        step = -lr * (mhat / (vhat.sqrt() + cfg_opt.eps)
                      + cfg_opt.weight_decay * ma)
        ulp = float(ma1.abs().max()) * torch.finfo(torch.float32).eps
        for k, got, want, den in (
                ("master", ma1, ma + step, float((ma + step).abs().max())),
                ("m", m1, m, float(m.abs().max())),
                ("v", v1, v, float(v.abs().max())),
                ("step", ma1 - ma, step, ulp)):
            if den:
                errs[k] = max(errs[k], float((got - want).abs().max()) / den)
    return errs


def _reduced_card_vs_cpu(dev):
    """Three AdamW updates of the reduced model's float32 tree from seeded
    gradients (the second above the clip norm), on the card and on the
    CPU.  Returns (the largest error relative to a leaf's largest |value|,
    the card's (params, state), the CPU's)."""
    import numpy as np
    import torch
    from repro_torch import optim
    from repro_torch.configs import get_arch
    from repro_torch.models import build
    from repro_torch.models.scan_util import tree_leaves, tree_map

    ocfg = optim.AdamWConfig(lr_peak=1e-2, warmup_steps=2, total_steps=10)
    params = build(get_arch(TRAIN_MODEL).reduced()).init(
        SERVE_SEED, device="cpu")
    rng = np.random.default_rng(SERVE_SEED)
    grads = [tree_map(lambda t: torch.from_numpy((rng.standard_normal(
        tuple(t.shape)) * s).astype(np.float32)), params)
        for s in (0.01, 0.5, 0.02)]
    runs = {}
    for where in ("cpu", dev):
        p = tree_map(lambda t: t.to(where), params)
        st = optim.init(p, ocfg)
        for g in grads:
            p, st = optim.update(tree_map(lambda t: t.to(where), g), st, ocfg,
                                 torch.float32)
        runs[str(where)] = (p, st)
    err = 0.0
    for a, b in zip(tree_leaves(runs[str(dev)]), tree_leaves(runs["cpu"])):
        if a.dtype == torch.int32:
            if not torch.equal(a.cpu(), b):
                raise AssertionError("train_parts: the step counts differ")
            continue
        den = float(b.abs().max())
        if den:
            err = max(err, float((a.cpu() - b).abs().max()) / den)
    return err, runs[str(dev)], grads


def _compress_checks(dev, grads):
    """`quantize_int8` on the card bit-equal to the CPU (a seeded normal
    and ties at both signs); `compressed_psum_mean` on a one-rank NCCL
    group equal, bit for bit, to the CPU's dequantized values and error
    feedback.  Returns the seconds of the NCCL warm-up."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.models.scan_util import tree_leaves, tree_map
    from repro_torch.optim import (
        compressed_psum_mean, dequantize_int8, quantize_int8)

    rng = np.random.default_rng(SERVE_SEED + 5)
    ties = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5],
                    np.float32)
    for x in (torch.from_numpy(rng.standard_normal(1 << 20).astype(
            np.float32)), torch.from_numpy(ties)):
        qc, sc = quantize_int8(x)
        qd, sd = quantize_int8(x.to(dev))
        if not (torch.equal(qd.cpu(), qc) and torch.equal(sd.cpu(), sc)):
            raise AssertionError("train_parts: quantize_int8 on the card "
                                 "differs from the CPU")
    ef = tree_map(lambda t: torch.from_numpy((rng.standard_normal(
        tuple(t.shape)) * 0.01).astype(np.float32)), grads)
    dist.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{_free_port()}",
        world_size=1, rank=0)
    try:
        t0 = time.perf_counter()
        dist.all_reduce(torch.zeros(1, device=dev))
        torch.cuda.synchronize()
        nccl_init_s = time.perf_counter() - t0
        red, ef2 = compressed_psum_mean(tree_map(lambda t: t.to(dev), grads),
                                        tree_map(lambda t: t.to(dev), ef))
    finally:
        dist.destroy_process_group()
    for g, e, r, e2 in zip(*(tree_leaves(x) for x in (grads, ef, red, ef2))):
        target = g + e
        deq = dequantize_int8(*quantize_int8(target))
        if not (torch.equal(r.cpu(), deq) and torch.equal(e2.cpu(),
                                                         target - deq)):
            raise AssertionError("train_parts: compressed_psum_mean on one "
                                 "rank differs from the CPU's quantizer")
    return nccl_init_s


def _ckpt_check(card_state):
    """`save_train_state` of the reduced card state (float32, and a
    bfloat16 copy with bfloat16 moments), restored on the CPU bit for
    bit.  Returns the leaves checked."""
    import tempfile

    import torch
    from repro_torch import optim
    from repro_torch.checkpoint import CheckpointManager, save_train_state
    from repro_torch.models.scan_util import tree_leaves, tree_map

    p, st = card_state
    pb = tree_map(lambda t: t.to(torch.bfloat16), p)
    bcfg = optim.AdamWConfig(moments_dtype="bfloat16")
    pb2, stb = optim.update(pb, optim.init(pb, bcfg), bcfg)
    checked = 0
    with tempfile.TemporaryDirectory() as d:
        for i, (params, state) in enumerate(((p, st), (pb2, stb))):
            mgr = CheckpointManager(f"{d}/run{i}")
            save_train_state(mgr, 3, params, state, blocking=i == 0)
            for sub, like in (("params", params), ("opt", state)):
                sm = CheckpointManager(f"{d}/run{i}/{sub}")
                sm.wait()
                back = sm.restore(3, like, device="cpu")
                for a, b in zip(tree_leaves(back), tree_leaves(like)):
                    if not (a.dtype == b.dtype and torch.equal(a, b.cpu())):
                        raise AssertionError(
                            f"train_parts: {sub} of run {i} did not "
                            "restore bit for bit")
                    checked += 1
    return checked


def train_parts_phase(card, dev):
    """train_parts (module docstring, phase 16)."""
    import torch
    from repro_torch import optim
    from repro_torch.configs import get_arch
    from repro_torch.models import build, param_count
    from repro_torch.models.scan_util import tree_leaves, tree_map

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    params = build(get_arch(TRAIN_MODEL)).init(SERVE_SEED, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SERVE_SEED + 3)
    grads = tree_map(lambda t: (torch.randn(
        t.shape, generator=gen, device=dev) * TRAIN_GRAD_STD).to(t.dtype),
        params)
    ocfg = optim.AdamWConfig(warmup_steps=0)
    state = optim.init(params, ocfg)
    torch.cuda.synchronize()
    start_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    # one update's outputs at a time: the state and its update are 49 GB
    device_ms = _time_ms(lambda: optim.update(grads, state, ocfg),
                         reps=TRAIN_REPS, warmup=1)
    host_ms = []
    for _ in range(TRAIN_REPS):
        t0 = time.perf_counter()
        new_params, new_state = optim.update(grads, state, ocfg)
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        if len(host_ms) < TRAIN_REPS:
            del new_params, new_state
    peak = torch.cuda.max_memory_allocated()
    gnorm = optim.global_norm(grads)
    scale = float(torch.clamp(ocfg.clip_norm / (gnorm + 1e-9), max=1.0))
    gnorm64 = sum(float((g.double() ** 2).sum())
                  for g in tree_leaves(grads)) ** 0.5
    norm_err = abs(float(gnorm) - gnorm64) / gnorm64
    errs = _full_update_check(ocfg, grads, state, new_params, new_state,
                              scale)
    # the bytes one update must move: the gradients read twice (the norm,
    # the update), master, m and v read and written, the params written
    gb, sb = _tree_bytes(grads), _tree_bytes(state[1:])
    nbytes = 2 * gb + 2 * sb + _tree_bytes(new_params)
    n_params = param_count(params)
    del params, grads, state, new_params, new_state
    torch.cuda.empty_cache()
    errs["reduced_card_vs_cpu"], card_state, red_grads = \
        _reduced_card_vs_cpu(dev)
    nccl_init_s = _compress_checks(dev, red_grads)
    checked = _ckpt_check(card_state)
    tols = dict(master=TRAIN_TOL, m=TRAIN_TOL, v=TRAIN_TOL,
                step=TRAIN_STEP_ULPS, reduced_card_vs_cpu=TRAIN_TOL)
    emit(phase="train_parts", model=TRAIN_MODEL, params=n_params,
         update_ms=statistics.median(host_ms), update_ms_min=min(host_ms),
         update_ms_max=max(host_ms), update_device_ms=device_ms,
         update_bytes=nbytes, bytes_per_param=nbytes / n_params,
         update_bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
         start_bytes=start_bytes, update_peak_bytes=peak,
         grad_norm=float(gnorm), grad_norm_rel_err=norm_err,
         clip_scale=scale, errors=errs, tols=tols,
         norm_tol=TRAIN_NORM_TOL, quantize_int8="bit-equal",
         psum_one_rank_nccl="bit-equal", nccl_init_s=nccl_init_s,
         ckpt_leaves_restored=checked,
         seconds=time.perf_counter() - t_phase, card=card)
    over = {k: e for k, e in errs.items() if not e <= tols[k]}
    if over or not norm_err <= TRAIN_NORM_TOL:
        raise AssertionError(f"train_parts: {over} above {tols}, or the "
                             f"norm's {norm_err} above {TRAIN_NORM_TOL}")


#: train_lm: training end to end on the card (`repro_torch.launch.train`)
TRAIN_LM_MODELS = ("internlm2-1.8b", "mamba2-370m")  # published widths
TRAIN_LM_BATCH = 4
TRAIN_LM_SEQ = 1024
TRAIN_LM_STEPS = 5           # timed steps; the first is the warm-up
TRAIN_LM_SEED = 0            # parameters and SyntheticTokens
#: (c) the reduced float32 configs: TRAIN_LM_RED_STEPS steps of B x S on
#: the card against the same steps on the CPU.  Losses, and each leaf of
#: m and v, within TRAIN_LM_TOL of the leaf's largest |value| (float32
#: sums in another order; measured at most 5.0e-6, zamba2-7b); params
#: and master by their update from the start, beyond one float32 ulp of
#: the value a step, within TRAIN_LM_UPDATE_TOL of the leaf's largest
#: update.  AdamW divides each entry's step by that entry's own gradient
#: size, so the gradients' float32 noise grows where a gradient is
#: small: measured at most 1.08e-3 (zamba2-7b); a missing, halved or
#: reversed last step is 0.2 or more
TRAIN_LM_RED_STEPS = 3
TRAIN_LM_RED_SHAPE = (2, 32)
TRAIN_LM_TOL = 1e-4
TRAIN_LM_UPDATE_TOL = 5e-3
#: ... except entries whose CPU gradient at some step is within
#: TRAIN_LM_NEAR of the leaf's largest |g|: AdamW's step there, lr · m̂ /
#: (sqrt(v̂) + eps), hangs on float32 noise, so they may move up to
#: TRAIN_LM_FLIP times the summed learning rates; at most
#: TRAIN_LM_FLIP_SHARE of the entries may need that
TRAIN_LM_NEAR = 2e-5
TRAIN_LM_FLIP = 2.0
TRAIN_LM_FLIP_SHARE = 1e-4
#: dense bf16 peak of one H100 SXM (NVIDIA's data sheet, without
#: sparsity), the FLOP term of the step's bound
BF16_PEAK_FLOPS = 989e12
#: seconds one launcher subprocess of the drill may take
TRAIN_LM_CLI_TIMEOUT = 300


def _step_flops(cfg, n_matmul: int, tokens: int, B: int, S: int) -> dict:
    """The training step's FLOPs: 6 x the matmul parameters x tokens (8 x
    with remat's recomputed forward) plus the sequence mixer's own
    products (causal attention's QK^T and PV, or the SSD chunk scan's
    quadratic and state terms), 3 x the forward's (4 x with remat)."""
    from repro_torch.models.ssm import _dims
    from repro_torch.models.transformer import layer_plan

    if cfg.mixer == "mamba":
        d_in, H, P, N, G, _ = _dims(cfg)
        Q = min(128, S)  # mamba_chunked's chunk
        mixer = cfg.n_layers * (2 * B * S * Q * H * (N + P)
                                + 4 * B * S * H * P * N)
    else:
        layers = sum(blk.count for blk in layer_plan(cfg))
        mixer = layers * 2 * B * cfg.n_heads * S * S * cfg.hd  # causal half
    return {"dense": 6 * n_matmul * tokens, "dense_remat": 8 * n_matmul
            * tokens, "mixer": 3 * mixer, "mixer_remat": 4 * mixer}


def _train_full(name, card, dev):
    """(a)/(b) of train_lm: TRAIN_LM_STEPS steps of `launch.train.make_step`
    at published width and depth in bf16, then the loss and backward's peak
    bytes with remat and without."""
    import torch
    from repro_torch import optim
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.launch.train import make_step
    from repro_torch.models import build, param_count, value_and_grad
    from repro_torch.models.scan_util import tree_leaves

    what = f"train_lm[{name}]"
    cfg = get_arch(name)
    bundle = build(cfg)
    B, S = TRAIN_LM_BATCH, TRAIN_LM_SEQ
    ocfg = optim.AdamWConfig()
    params = bundle.init(TRAIN_LM_SEED, device=dev)
    state = optim.init(params, ocfg)
    n_params = param_count(params)
    n_matmul = n_params - (0 if cfg.tie_embeddings
                           else params["embed"]["w"].numel())
    step = make_step(bundle, ocfg, cfg, False, None)
    data = SyntheticTokens(cfg.vocab, S, B, seed=TRAIN_LM_SEED)
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in
                data.batch(i).items()} for i in range(TRAIN_LM_STEPS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses = [], []
    for batch in batches:
        t0 = time.perf_counter()
        params, state, loss = step(params, state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    step_peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(x) for x in losses) or not all(
            bool(torch.isfinite(t).all()) for t in tree_leaves(params)):
        raise AssertionError(f"{what}: a loss or a parameter is not "
                             f"finite: {losses}")

    # the loss and its backward alone, with remat and without: the update
    # after it peaks alike either way (params, state and their new copies)
    grad_peak = {}
    for remat in (True, False):
        grad = value_and_grad(
            lambda p, b, r=remat: bundle.loss_fn(p, b, remat=r)[0])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        loss, g = grad(params, batches[-1])
        torch.cuda.synchronize()
        grad_peak[remat] = torch.cuda.max_memory_allocated()
        del loss, g
        torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    if not grad_peak[True] < grad_peak[False]:
        raise AssertionError(f"{what}: remat's peak {grad_peak[True]} is "
                             f"not below {grad_peak[False]}")
    tokens = B * S
    flops = _step_flops(cfg, n_matmul, tokens, B, S)
    # the update's bytes (train_parts): the gradients read twice, master,
    # m and v read and written, the params written
    upd_bytes = n_params * (3 * params["embed"]["w"].element_size() + 24)
    upd_ms = upd_bytes / HBM_BYTES_PER_S * 1e3
    flop_ms = (flops["dense_remat"] + flops["mixer_remat"]) \
        / BF16_PEAK_FLOPS * 1e3
    med = statistics.median(step_ms[1:])
    emit(phase="train_lm", model=name, params=n_params, matmul_params=n_matmul,
         batch=B, seq=S, dtype=cfg.dtype, steps=len(step_ms),
         step_ms=med, step_ms_min=min(step_ms[1:]),
         step_ms_max=max(step_ms[1:]), warmup_step_ms=step_ms[0],
         tokens_per_s=tokens / med * 1e3, losses=losses, flops=flops,
         bound_ms=flop_ms + upd_ms, bound_flop_ms=flop_ms,
         bound_flop_ms_without_remat=(flops["dense"] + flops["mixer"])
         / BF16_PEAK_FLOPS * 1e3, bound_update_ms=upd_ms,
         bound_share=(flop_ms + upd_ms) / med, peak_flops=BF16_PEAK_FLOPS,
         step_peak_bytes=step_peak, grad_peak_bytes_remat=grad_peak[True],
         grad_peak_bytes_no_remat=grad_peak[False], held_bytes=held,
         card=card)
    del params, state, batches
    torch.cuda.empty_cache()


def _update_errors(got, want, start, grads, steps: int) -> dict:
    """Leaf by leaf (lists of tensors, one order), the update `got -
    start` against `want - start` after `steps` AdamW steps.  An entry's
    error is |Δgot - Δwant| less one float32 ulp of its value a step
    (each step rounds the master once on either side).  `grads[s]` holds
    `want`'s gradient leaves of step s, or `grads` is None: an entry
    whose gradient at some step is within TRAIN_LM_NEAR of that step's
    largest |g| of the leaf is "near" (see TRAIN_LM_FLIP).  Returns
    {"update": the largest error of an entry not near, relative to its
    leaf's largest |Δwant|; "near_over_lrs_sum": the largest error of a
    near entry (absolute, divided by the caller); "near_used": the near
    entries beyond TRAIN_LM_UPDATE_TOL of that scale; "entries"}."""
    import torch

    worst, near_worst, used, total = 0.0, 0.0, 0, 0
    for k, (a, b, s0) in enumerate(zip(got, want, start)):
        a, b, s0 = (t.detach().cpu().double() for t in (a, b, s0))
        ulp = torch.nextafter(
            torch.maximum(s0.abs(), b.abs()).float(),
            torch.tensor(float("inf"))).double() \
            - torch.maximum(s0.abs(), b.abs()).float().double()
        err = ((a - s0) - (b - s0)).abs().sub(steps * ulp).clamp(min=0)
        scale = float((b - s0).abs().max()) or 1.0
        near = torch.zeros(a.shape, dtype=torch.bool)
        for g in grads or ():
            g = g[k].detach().cpu().abs()
            near |= g <= TRAIN_LM_NEAR * float(g.max())
        far, close = err[~near], err[near]
        if far.numel():
            worst = max(worst, float(far.max()) / scale)
        if close.numel():
            near_worst = max(near_worst, float(close.max()))
            used += int((close > TRAIN_LM_UPDATE_TOL * scale).sum())
        total += a.numel()
    return {"update": worst, "near_over_lrs_sum": near_worst,
            "near_used": used, "entries": total}


def _moment_error(got, want) -> float:
    """The largest error of a leaf of `got` against `want` (m or v),
    relative to the leaf's largest |value|."""
    from repro_torch.models.scan_util import tree_leaves

    err = 0.0
    for x, y in zip(tree_leaves(got), tree_leaves(want)):
        y = y.cpu().double()
        d = float((x.cpu().double() - y).abs().max())
        den = float(y.abs().max())
        err = max(err, d / den if den else d)
    return err


def _train_errors(got, want, start, grads, lrs) -> dict:
    """(c)/(d): `got` against `want`, each (params, AdamWState, losses or
    None), from the params `start` through len(lrs) steps at those
    learning rates; {"loss", "moments", "update", "near_over_lrs_sum",
    "near_used", "entries"}, the update's the worse of params' and
    master's."""
    from repro_torch.models.scan_util import tree_leaves

    (gp, gs, gl), (wp, ws, wl) = got, want
    out = {"loss": max((abs(a - b) / abs(b) for a, b in zip(gl, wl)),
                       default=0.0) if gl else 0.0,
           "moments": max(_moment_error(gs.m, ws.m),
                          _moment_error(gs.v, ws.v))}
    start = tree_leaves(start)
    for g, w in ((gp, wp), (gs.master, ws.master)):
        e = _update_errors(tree_leaves(g), tree_leaves(w), start, grads,
                           len(lrs))
        e["near_over_lrs_sum"] /= sum(lrs)
        for key, v in e.items():
            out[key] = max(out.get(key, v), v)
    return out


def _train_failures(errs: dict) -> dict:
    """The entries of {name: _train_errors(...)} that break a bound."""
    return {name: e for name, e in errs.items()
            if not (e["loss"] <= TRAIN_LM_TOL and e["moments"] <= TRAIN_LM_TOL
                    and e["update"] <= TRAIN_LM_UPDATE_TOL
                    and e["near_over_lrs_sum"] <= TRAIN_LM_FLIP
                    and e["near_used"] <= TRAIN_LM_FLIP_SHARE * e["entries"])}


def _train_reduced(dev):
    """(c) of train_lm: every architecture's reduced float32 config,
    TRAIN_LM_RED_STEPS steps on the card and on the CPU from the same
    weights and batches.  Returns {name: `_train_errors`} (card against
    CPU, the CPU's gradients marking the near entries)."""
    import argparse

    import torch
    from repro_torch import optim
    from repro_torch.configs import ARCHS
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.launch.train import _host_batch, make_step
    from repro_torch.models import build, value_and_grad
    from repro_torch.models.scan_util import tree_leaves, tree_map

    B, S = TRAIN_LM_RED_SHAPE
    ocfg = optim.AdamWConfig(total_steps=10)
    lrs = [float(optim.cosine_lr(ocfg, i + 1))
           for i in range(TRAIN_LM_RED_STEPS)]
    errs = {}
    for name, full in sorted(ARCHS.items()):
        cfg = full.reduced()
        bundle = build(cfg)
        params = bundle.init(TRAIN_LM_SEED, device="cpu")
        data = SyntheticTokens(cfg.vocab, S, B, seed=TRAIN_LM_SEED)
        args = argparse.Namespace(batch=B, seq=S)
        batches = [_host_batch(data, cfg, args, i)
                   for i in range(TRAIN_LM_RED_STEPS)]
        grad = value_and_grad(
            lambda p, b: bundle.loss_fn(p, b, remat=True)[0])
        runs, grads = {}, []
        for where in ("cpu", dev):
            p = tree_map(lambda t: t.to(where), params)
            st = optim.init(p, ocfg)
            step = make_step(bundle, ocfg, cfg, False, None)
            losses = []
            for b in batches:
                b = {k: torch.from_numpy(v).to(where) for k, v in b.items()}
                if str(where) == "cpu":
                    grads.append(tree_leaves(grad(p, b)[1]))
                p, st, loss = step(p, st, b)
                losses.append(float(loss))
            runs[str(where)] = (p, st, losses)
        errs[name] = _train_errors(runs[str(dev)], runs["cpu"], params,
                                   grads, lrs)
    return errs


def _train_cli(args, dev, background=False):
    """`python -m repro_torch.launch.train` on the reduced internlm2 with
    `args`, from the checkout's `src`, on the launcher's default device
    (the card), or with `--device cpu` when `dev` is the CPU; a Popen
    when `background`."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           TRAIN_MODEL, "--reduced", "--batch", "2", "--seq", "32", *args]
    if dev.type == "cpu":
        cmd += ["--device", "cpu"]
    if background:
        return subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
    return subprocess.run(cmd, env=env, capture_output=True, text=True,
                          timeout=TRAIN_LM_CLI_TIMEOUT)


def _train_drill(dev):
    """(d) of train_lm: the fault drill through the CLI on the card (exit
    42 at step 6, `--resume auto` restores it and exits 0), its final
    checkpoint against an uninterrupted run's, and a run with
    `--grad-compression` (the launcher's one-rank NCCL group).  Returns
    (`_train_errors` of the resumed run against the whole one, whether
    bit-equal, the seconds of the runs)."""
    import tempfile

    import torch
    from repro_torch import optim
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_arch
    from repro_torch.models import build
    from repro_torch.models.scan_util import tree_leaves

    with tempfile.TemporaryDirectory() as d:
        drill = ["--ckpt-dir", f"{d}/ck", "--ckpt-every", "3", "--steps", "9"]
        t0 = time.perf_counter()
        full = _train_cli(["--ckpt-dir", f"{d}/full", "--ckpt-every", "3",
                           "--steps", "9"], dev, background=True)
        comp = _train_cli(["--steps", "3", "--grad-compression"], dev,
                          background=True)
        r1 = _train_cli([*drill, "--simulate-failure", "6"], dev)
        r2 = _train_cli([*drill, "--resume", "auto"], dev)
        outs = {}
        for what, p in (("full", full), ("compression", comp)):
            out, err = p.communicate(timeout=TRAIN_LM_CLI_TIMEOUT)
            outs[what] = (p.returncode, out, err)
        seconds = time.perf_counter() - t0
        checks = {
            "exit 42 at step 6": r1.returncode == 42
            and "[fault] injected failure at step 6" in r1.stdout,
            "resume": r2.returncode == 0
            and "[resume] restored step 6" in r2.stdout,
            "uninterrupted": outs["full"][0] == 0,
            "compression": outs["compression"][0] == 0
            and "done: 3 steps" in outs["compression"][1]}
        if not all(checks.values()):
            raise AssertionError(
                f"train_lm drill: {checks}; stderr: {r1.stderr[-800:]} "
                f"{r2.stderr[-800:]} {outs['full'][2][-800:]} "
                f"{outs['compression'][2][-800:]}")
        cfg = get_arch(TRAIN_MODEL).reduced()
        # the launcher's start: its --seed (0) drawn on the same device
        start = build(cfg).init(0, device=dev)
        state = optim.init(start, optim.AdamWConfig())
        got = [CheckpointManager(f"{d}/{run}/{sub}").restore(
            9, t, device="cpu") for run in ("ck", "full")
            for sub, t in (("params", start), ("opt", state))]
    resumed, whole = got[:2], got[2:]
    bit_equal = all(torch.equal(a, b) for a, b in zip(
        tree_leaves(resumed), tree_leaves(whole)))
    ocfg = optim.AdamWConfig(total_steps=10)
    lrs = [float(optim.cosine_lr(ocfg, i + 1)) for i in range(9)]
    err = _train_errors((*resumed, None), (*whole, None), start, None, lrs)
    return err, bit_equal, seconds


def train_lm_phase(card, dev, models=TRAIN_LM_MODELS):
    """train_lm (module docstring, phase 17)."""
    import torch

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    for name in models:
        _train_full(name, card, dev)
    t_full = time.perf_counter() - t0
    red = _train_reduced(dev)
    t_red = time.perf_counter() - t0 - t_full
    drill_err, bit_equal, drill_s = _train_drill(dev)
    emit(phase="train_lm", reduced_card_vs_cpu=red, tol=TRAIN_LM_TOL,
         update_tol=TRAIN_LM_UPDATE_TOL, near=TRAIN_LM_NEAR,
         flip=TRAIN_LM_FLIP, flip_share=TRAIN_LM_FLIP_SHARE,
         drill="exit 42, resumed at step 6, exit 0",
         drill_resumed_vs_whole=drill_err,
         drill_bit_equal=bit_equal, drill_seconds=drill_s,
         grad_compression_cli="one-rank group, done",
         seconds_full=t_full, seconds_reduced=t_red,
         seconds=time.perf_counter() - t0, card=card)
    over = _train_failures(dict(red, drill_resumed_vs_whole=drill_err))
    if over:
        raise AssertionError(f"train_lm: {over} break the bounds "
                             f"(TRAIN_LM_TOL {TRAIN_LM_TOL}, "
                             f"TRAIN_LM_UPDATE_TOL {TRAIN_LM_UPDATE_TOL}, "
                             f"TRAIN_LM_FLIP {TRAIN_LM_FLIP}, "
                             f"TRAIN_LM_FLIP_SHARE {TRAIN_LM_FLIP_SHARE})")


#: lm_mesh: the production mesh's placement and the dry run on the card
LM_MESH_MODEL = "internlm2-1.8b"
#: (b) the dry run's matmul FLOPs against the formula, relative
LM_MESH_FLOP_TOL = 0.02
#: (b) the dry run's peak against the card's max_memory_allocated,
#: relative: allocation rounding, the BLAS workspaces and storages that
#: Python frees later than the card's allocator are each far below it
#: (PERF.md §6)
LM_MESH_PEAK_TOL = 0.10
#: (c) processes counting at once, and the phase's time limit (s)
LM_MESH_WORKERS = 8
LM_MESH_SECONDS = 180.0
#: (c) the fits that take longest (most layers in their probes), started
#: first so that the others fill the workers around them
LM_MESH_SLOW = ("zamba2-7b", "gemma3-1b", "deepseek-v3-671b",
                "mamba2-370m")
#: (c) the cells counted at full depth, each against its fit
LM_MESH_FULL = (("internlm2-1.8b", "train_4k"),
                ("internlm2-1.8b", "decode_32k"))
_LM_MESH_TASK = """
import json, sys
sys.path.insert(0, {src!r})
from repro_torch.launch import dryrun as DR, extrapolate as EX
kind, arch, shape = {task!r}
rec = (EX.extrapolate_cell(arch, shape, verbose=False) if kind == "fit"
       else DR.run_cell(arch, shape, False, verbose=False))
print(json.dumps(rec))
"""


def _mesh_placed_step(card, dev, name):
    """(a) of lm_mesh: the plain and the placed step; returns the placed
    step's peak bytes."""
    import torch
    import torch.distributed as dist
    from repro_torch import optim
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.train import make_step, place_batch, place_state
    from repro_torch.models import build
    from repro_torch.models.scan_util import tree_leaves

    what = f"lm_mesh[{name}]"
    cfg = get_arch(name)
    bundle = build(cfg)
    ocfg = optim.AdamWConfig()
    B, S = TRAIN_LM_BATCH, TRAIN_LM_SEQ
    params = bundle.init(TRAIN_LM_SEED, device=dev)
    state = optim.init(params, ocfg)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in SyntheticTokens(
        cfg.vocab, S, B, seed=TRAIN_LM_SEED).batch(0).items()}
    step = make_step(bundle, ocfg, cfg, False, None)

    def timed(*args):  # one warm-up, then the step timed and its peak
        step(*args)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = step(*args)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3, \
            torch.cuda.max_memory_allocated()

    (p1, s1, loss1), plain_ms, plain_peak = timed(params, state, batch)
    host = [t.cpu() for t in tree_leaves((p1, s1))]
    loss1 = float(loss1)
    del p1, s1
    torch.cuda.empty_cache()
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        init_method=f"tcp://127.0.0.1:{_free_port()}", world_size=1, rank=0)
    try:
        mesh = SH.Mesh(("data", "model"), (1, 1))
        dmesh = SH.device_mesh(mesh, dev)
        # the same storage, placed (one rank: nothing is copied)
        pp, ps = place_state(params, state, mesh, dmesh)
        del params, state
        pb = place_batch(batch, mesh, dmesh)
        (q1, t1, loss2), mesh_ms, mesh_peak = timed(pp, ps, pb)
        got = [t.to_local() for t in tree_leaves((q1, t1))]
        unequal = [i for i, (a, b) in enumerate(zip(got, host))
                   if a.dtype != b.dtype or not torch.equal(a, b.to(dev))]
        worst = max((float((got[i].double() - host[i].to(dev).double())
                           .abs().max()) for i in unequal), default=0.0)
        loss2, n_leaves = float(loss2), len(got)
        del q1, t1, got, pp, ps
    finally:
        dist.destroy_process_group()
    del host
    torch.cuda.empty_cache()
    emit(phase="lm_mesh", part="a", model=name, batch=B, seq=S,
         dtype=cfg.dtype, plain_step_ms=plain_ms, placed_step_ms=mesh_ms,
         loss_plain=loss1, loss_placed=loss2, leaves=n_leaves,
         unequal_leaves=len(unequal), worst_abs_diff=worst,
         plain_peak_bytes=plain_peak, placed_peak_bytes=mesh_peak,
         card=card)
    if unequal or loss1 != loss2:
        raise AssertionError(f"{what}: the placed step differs from the "
                             f"plain one: loss {loss2} vs {loss1}, "
                             f"{len(unequal)} leaves (largest |diff| "
                             f"{worst})")
    return mesh_peak


def _mesh_dry_run(card, dev, name, peak):
    """(b) of lm_mesh: the dry run of (a)'s cell on a (1, 1) fake mesh
    against the formula and the card's peak."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import dryrun as DR
    from repro_torch.models import build
    from repro_torch.models.scan_util import tree_leaves
    from repro_torch.models.transformer import layer_plan

    what = f"lm_mesh[{name}] dry run"
    cfg = get_arch(name)
    B, S = TRAIN_LM_BATCH, TRAIN_LM_SEQ
    m = DR.measure_cell(cfg, ShapeConfig("train_lm", "train", S, B),
                        SH.Mesh(("data", "model"), (1, 1)),
                        device=dev.type)
    params = build(cfg).init(0, device="meta")
    n_params = sum(t.numel() for t in tree_leaves(params))
    n_matmul = n_params - (0 if cfg.tie_embeddings
                           else params["embed"]["w"].numel())
    head = (params["embed"]["w"] if cfg.tie_embeddings
            else params["lm_head"]["w"]).numel()
    down = sum(blk.count for blk in layer_plan(cfg)) * cfg.d_ff \
        * cfg.d_model
    tokens = B * S
    f = _step_flops(cfg, n_matmul, tokens, B, S)
    formula = f["dense_remat"] + f["mixer_remat"]
    # the three terms the formula leaves out: eager attention computes
    # its masked half too (x 2 on the causal mixer); the logits' product
    # lies outside remat (6 x its parameters, not 8 x); and remat's
    # recompute stops once the backward's saved inputs are back, before
    # each layer's last product, the MLP's down projection (6 x, not 8 x)
    named = formula + f["mixer_remat"] - 2 * (head + down) * tokens
    pred_peak = m["argument_bytes"] + m["temp_bytes"]
    flop_err = abs(m["flops"] - named) / named
    peak_err = abs(pred_peak - peak) / peak
    emit(phase="lm_mesh", part="b", model=name, flops=m["flops"],
         step_flops=formula, step_flops_named=named,
         flops_vs_step_flops=m["flops"] / formula, flop_err=flop_err,
         flop_tol=LM_MESH_FLOP_TOL, predicted_peak_bytes=pred_peak,
         argument_bytes=m["argument_bytes"], temp_bytes=m["temp_bytes"],
         card_peak_bytes=peak, peak_err=peak_err,
         peak_tol=LM_MESH_PEAK_TOL, bytes=m["bytes"],
         collectives=m["coll_by_kind"], seconds=m["build_s"] + m["run_s"],
         card=card)
    if flop_err > LM_MESH_FLOP_TOL or peak_err > LM_MESH_PEAK_TOL:
        raise AssertionError(f"{what}: FLOPs off by {flop_err:.4f} "
                             f"(tol {LM_MESH_FLOP_TOL}), peak off by "
                             f"{peak_err:.4f} (tol {LM_MESH_PEAK_TOL})")


def _mesh_fits(card, archs=None):
    """(c) of lm_mesh: the fits (of `archs`, default all ten) and the
    full-depth counts, each in a process of its own (a fake group is one
    a process), LM_MESH_WORKERS at once."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.configs import ARCHS

    archs = sorted(ARCHS) if archs is None else archs
    archs = sorted(archs, key=lambda a: (a not in LM_MESH_SLOW, a))
    tasks = [("fit", a, "train_4k") for a in archs]
    tasks += [("fit", a, s) for a, s in LM_MESH_FULL if s != "train_4k"]
    tasks += [("full", a, s) for a, s in LM_MESH_FULL]
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(SRC))

    def run(task):
        r = subprocess.run(
            [sys.executable, "-c", _LM_MESH_TASK.format(src=str(SRC),
                                                        task=task)],
            capture_output=True, text=True, env=env, timeout=LM_MESH_SECONDS)
        if r.returncode:
            raise AssertionError(f"lm_mesh {task}: exit {r.returncode}: "
                                 f"{r.stderr[-1500:]}")
        return json.loads(r.stdout.strip().splitlines()[-1])

    with ThreadPoolExecutor(LM_MESH_WORKERS) as pool:
        recs = dict(zip(tasks, pool.map(run, tasks)))
    keys = ("per_device_flops", "per_device_bytes",
            "collective_bytes_per_device", "collective_bytes_total")
    for (kind, arch, shape), rec in recs.items():
        if rec["status"] != "OK":
            raise AssertionError(f"lm_mesh {kind} {arch} {shape}: {rec}")
        emit(phase="lm_mesh", part="c", kind=kind, model=arch, shape=shape,
             mesh=rec["mesh"], compute_term_s=rec["compute_term_s"],
             memory_term_s=rec["memory_term_s"],
             collective_term_s=rec["collective_term_s"],
             **{k: rec[k] for k in keys}, memory=rec["memory_analysis"],
             rates="H100 SXM data sheet", card=card)
    for arch, shape in LM_MESH_FULL:
        fit, whole = recs[("fit", arch, shape)], recs[("full", arch, shape)]
        off = [k for k in keys if fit[k] != whole[k]]
        if off:
            raise AssertionError(f"lm_mesh {arch} {shape}: the fit differs "
                                 f"from full depth in {off}")
    return recs


def lm_mesh_phase(card, dev):
    """lm_mesh (module docstring, phase 18)."""
    import torch

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    peak = _mesh_placed_step(card, dev, LM_MESH_MODEL)
    t_a = time.perf_counter() - t0
    _mesh_dry_run(card, dev, LM_MESH_MODEL, peak)
    t_b = time.perf_counter() - t0 - t_a
    _mesh_fits(card)
    seconds = time.perf_counter() - t0
    emit(phase="lm_mesh", seconds=seconds, seconds_a=t_a, seconds_b=t_b,
         seconds_c=seconds - t_a - t_b, limit=LM_MESH_SECONDS, card=card)
    if seconds > LM_MESH_SECONDS:
        raise AssertionError(f"lm_mesh took {seconds:.1f} s, over "
                             f"{LM_MESH_SECONDS}")


def _mix_gather(svc, rng, n, count):
    return [svc.core_of(int(rng.integers(n))) if rng.random() < 0.5
            else svc.degree_of(int(rng.integers(n))) for _ in range(count)]


def _mix_mixed(svc, rng, n, count):
    out = []
    for _ in range(count):
        r = int(rng.integers(5))
        u, v = int(rng.integers(n)), int(rng.integers(n))
        out.append([svc.core_of(u), svc.degree_of(u), svc.nbr_max_core_of(u),
                    svc.same_component(u, v),
                    svc.topk_pagerank(SERVICE_MIXED_K)][r])
    return out


def _mix_topk(svc, rng, n, count):
    return [svc.topk_pagerank(int(rng.integers(1, SERVICE_TOPK_MAX + 1)))
            for _ in range(count)]


#: the query mixes of the JAX package's benchmarks/bench_service.py
SERVICE_MIXES = {"gather": _mix_gather, "mixed": _mix_mixed,
                 "topk": _mix_topk}


def _interleave(ups):
    """Inserts and deletes in turns, as bench_service._mixed_updates
    orders them, so every window carries both ops."""
    half = len(ups) // 2
    return [u for pair in zip(ups[:half], ups[half:]) for u in pair]


def _service_pass(g, core, labels, ups, mix, backend):
    """One `QueryServer.serve` of `ups` on a copy of `g`, `mix`'s queries
    (SERVICE_QPW before each window, ids in [0, N), from SERVICE_SEED)
    submitted through it.  Records every request, every published
    snapshot by epoch and each refresh's host seconds (between two
    syncs).  Returns {"srv", "res", "requests", "snaps",
    "refresh_seconds", "seconds"}."""
    import numpy as np
    import torch
    import repro_torch.service as svc
    from repro_torch.runtime import StreamSession

    sess = StreamSession(g.clone(), core.clone(), R=R, backend=backend,
                         cc_labels=labels.clone())
    srv = svc.QueryServer(sess, config=svc.ServiceConfig(**SERVICE_CONFIG))
    out = {"srv": srv, "requests": [], "snaps": {0: srv.state.snapshot},
           "refresh_seconds": []}
    submit, refresh = srv.submit, srv.state.refresh

    def recorded_submit(query):
        req = submit(query)
        out["requests"].append(req)
        return req

    def timed_refresh():
        torch.cuda.synchronize()
        t = time.perf_counter()
        snap = refresh()
        torch.cuda.synchronize()
        out["refresh_seconds"].append(time.perf_counter() - t)
        out["snaps"][snap.epoch] = snap
        return snap

    srv.submit, srv.state.refresh = recorded_submit, timed_refresh
    rng = np.random.default_rng(SERVICE_SEED)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out["res"] = srv.serve(list(ups),
                           lambda i: mix(svc, rng, g.N, SERVICE_QPW))
    torch.cuda.synchronize()
    out["seconds"] = time.perf_counter() - t0
    return out


def _epoch_oracles(g, snaps):
    """From-scratch recompute on every epoch's snapshot graph through the
    kernels (`coreness`, `connected_components`, `pagerank(tol=None,
    max_steps=pr_steps)` on "ell"), held bit for bit against the
    snapshot's own fields; returns {epoch: host arrays} with each node's
    neighbor max coreness and the top ranks' ids in `jax.lax.top_k`'s
    order (rank descending, the lower id first), from numpy's lexsort."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.core import connected_components, coreness, pagerank

    out = {}
    for epoch, snap in sorted(snaps.items()):
        eg = dataclasses.replace(g, nbr=snap.nbr, deg=snap.deg,
                                 node_mask=snap.node_mask,
                                 orig_id=snap.orig_id)
        fields = {
            "core": coreness(eg, backend="ell"),
            "labels": connected_components(eg, backend="ell"),
            "rank": pagerank(eg, alpha=SERVICE_CONFIG["alpha"], tol=None,
                             max_steps=SERVICE_CONFIG["pr_steps"],
                             backend="ell")}
        for k, v in fields.items():
            if not torch.equal(v, getattr(snap, k)):
                raise AssertionError(f"service_ds1: epoch {epoch} snapshot "
                                     f"{k} != recompute")
        core = fields["core"]
        fields["nbr_max"] = torch.where(
            eg.nbr >= 0, core[eg.nbr.clamp(min=0).long()], -1).max(1).values
        fields["deg"] = eg.deg
        host = {k: v.cpu().numpy() for k, v in fields.items()}
        host["order"] = np.lexsort((np.arange(g.N), -host["rank"]))[
            :SERVICE_TOPK_MAX]
        out[epoch] = host
    return out


def _check_service_answers(requests, oracles, what):
    """Every answer equal to its epoch's recompute (ranks bit for bit)."""
    for r in requests:
        if r is None or not r.done:
            raise AssertionError(f"{what}: a query was shed or not answered")
        o, q = oracles[r.epoch], r.query
        if q.kind == "topk_pagerank":
            ids = o["order"][:q.k].tolist()
            want = (ids, o["rank"][ids].tolist())
        elif q.kind == "same_component":
            want = bool(o["labels"][q.u] == o["labels"][q.v])
        else:
            field = {"core": "core", "degree": "deg",
                     "nbr_max_core": "nbr_max"}[q.kind]
            want = int(o[field][q.u])
        if r.answer != want:
            raise AssertionError(f"{what}: {q} answered {r.answer} at epoch "
                                 f"{r.epoch}, the recompute gives {want}")


def _same_service_answers(e, p, what):
    """The ell run's answers against the plain run's: integers, booleans
    and top-k ids equal, ranks allclose at RANK_TOL.  Where two top-k
    lists differ, every differing pair of ids must carry ranks within
    RANK_TOL of each other in both runs (a tie within the tolerance).
    Returns the count of such lists."""
    import numpy as np

    swaps = 0
    for a, b in zip(e["requests"], p["requests"], strict=True):
        if tuple(a.query) != tuple(b.query) or a.epoch != b.epoch:
            raise AssertionError(f"{what}: the runs' requests differ")
        if a.query.kind != "topk_pagerank":
            if a.answer != b.answer:
                raise AssertionError(f"{what}: {a.query} ell {a.answer} vs "
                                     f"plain {b.answer}")
            continue
        (ia, ra), (ib, rb) = a.answer, b.answer
        if not np.allclose(ra, rb, **RANK_TOL):
            raise AssertionError(f"{what}: top-k ranks differ: {ra} vs {rb}")
        if ia != ib:
            ea = e["snaps"][a.epoch].rank.cpu().numpy()
            pb = p["snaps"][b.epoch].rank.cpu().numpy()
            for rank in (ea, pb):
                if not np.allclose(rank[ia], rank[ib], **RANK_TOL):
                    raise AssertionError(f"{what}: top-k ids differ beyond "
                                         f"a tie: {ia} vs {ib}")
            swaps += 1
    return swaps


def service_phase(g, core, ups, card):
    """The query service on DS1 (module docstring, phase 8), with the
    settings of the JAX package's benchmarks/bench_service.py: for each
    mix, two `serve` passes on fresh copies through the kernels, the
    second reported; every answer held against the recompute on its
    epoch's graph, the mixed mix also against a plain pass."""
    import torch
    from repro_torch.core import compute_degrees, connected_components

    what = "service_ds1"
    if not torch.equal(compute_degrees(g), g.deg):
        raise AssertionError(f"{what}: compute_degrees != g.deg")
    labels = connected_components(g, backend="torch")
    ups = _interleave(ups)
    ref_snaps, oracles, checked = None, None, 0

    def line(mix, backend, run, launches, warmup_seconds=None):
        s = run["srv"].metrics.summary()
        secs = run["refresh_seconds"]
        emit(phase=what, mix=mix, backend=backend,
             windows=run["res"].stats.batches, queries_per_window=SERVICE_QPW,
             **{k: s[k] for k in ("p50_ms", "p99_ms", "qps", "answered",
                                  "shed", "batches", "staleness_max")},
             refreshes=run["srv"].state.refreshes,
             refresh_seconds_mean=sum(secs) / len(secs),
             refresh_seconds_max=max(secs), path_seconds=run["seconds"],
             warmup_path_seconds=warmup_seconds, launches=launches,
             stream_stats=run["res"].stats._asdict(), card=card)
        if s["shed"]:
            raise AssertionError(f"{what}: {s['shed']} queries shed")

    runs = {}
    for mix, fn in SERVICE_MIXES.items():
        warm = _service_pass(g, core, labels, ups, fn, "ell")
        run, launches = _counted(
            lambda: _service_pass(g, core, labels, ups, fn, "ell"),
            SERVICE_KERNELS)
        if ref_snaps is None:  # the epochs' graphs are the same every run
            ref_snaps = run["snaps"]
            oracles = _epoch_oracles(g, ref_snaps)
        for epoch, snap in run["snaps"].items():
            ref = ref_snaps[epoch]
            if not all(torch.equal(a, b) for a, b in zip(snap, ref)
                       if isinstance(a, torch.Tensor)):
                raise AssertionError(f"{what}: {mix} epoch {epoch} snapshot "
                                     "differs from the first run's")
        _check_service_answers(run["requests"], oracles, f"{what} {mix}")
        checked += len(run["requests"])
        line(mix, "ell", run, launches, warm["seconds"])
        runs[mix] = run

    for name in KERNELS:
        _wrapper(name).launches = 0
    plain = _service_pass(g, core, labels, ups, SERVICE_MIXES["mixed"],
                          "torch")
    torch.cuda.synchronize()
    launches = {name: _wrapper(name).launches for name in SERVICE_KERNELS}
    if any(launches.values()):
        raise AssertionError(f"{what}: the plain run launched {launches}")
    line("mixed", "torch", plain, launches)
    swaps = _same_service_answers(runs["mixed"], plain, f"{what} mixed")
    e, p = runs["mixed"]["res"], plain["res"]
    if not (torch.equal(e.core, p.core) and torch.equal(e.labels, p.labels)
            and torch.equal(e.g.nbr, p.g.nbr) and e.stats == p.stats):
        raise AssertionError(f"{what}: the ell and plain sessions differ")
    last = oracles[max(oracles)]
    if not ((e.core.cpu().numpy() == last["core"]).all()
            and (e.labels.cpu().numpy() == last["labels"]).all()
            and torch.equal(compute_degrees(e.g), e.g.deg)):
        raise AssertionError(f"{what}: the session's end state != recompute")
    emit(phase=what + "_check", epochs=len(oracles), answers_checked=checked,
         topk_near_tie_swaps_vs_plain=swaps, compute_degrees="== g.deg",
         card=card)


def skew_graph(dev, card, scale=1.0):
    """`benchmarks/bench_skew.py`'s graph at the paper's full ego-Facebook
    size (`snap_like("ego-Facebook", 1.0, seed=0)`, random cut into 8
    blocks, one padding row per replica the split needs) and its split at
    SKEW_THRESHOLD.  `mirror_report`'s counters must equal SKEW_REPORT
    (checked at scale 1 only).  Returns (g, g2, plan, assign)."""
    import numpy as np
    from repro_torch.core import build_blocks, mirror_report, split_hubs
    from repro_torch.core.partition import node_random_partition
    from repro_torch.graphgen import snap_like

    t0 = time.perf_counter()
    edges = snap_like("ego-Facebook", scale, seed=0)
    n = int(edges.max()) + 1
    deg = np.bincount(edges.ravel(), minlength=n)
    replicas = int(np.maximum(0, -(-deg // SKEW_THRESHOLD) - 1).sum())
    assign = node_random_partition(n, 8, seed=0)
    g = build_blocks(edges, n, assign, P=8, node_slack=replicas, device=dev)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    g2, plan = split_hubs(g, SKEW_THRESHOLD)
    split_s = time.perf_counter() - t0
    rep = mirror_report(g, g2, plan)
    counters = dict(
        Cd_unsplit=g.Cd, Cd_split=g2.Cd, slots_unsplit=rep["slots_unsplit"],
        slots_split=rep["slots_split"], inter_unsplit=rep["inter_unsplit"],
        inter_split=rep["inter_split"], n_groups=rep["n_groups"],
        replica_rows=g2.n_real - g.n_real, Gmax=plan.Gmax, Km=plan.Km)
    if scale == 1.0 and counters != SKEW_REPORT:
        raise AssertionError(f"skew_graph: mirror_report's counters "
                             f"{counters} != {SKEW_REPORT}")
    emit(phase="skew_graph", n=n, m=int(len(edges)), card=card,
         max_degree=int(deg.max()), mean_degree=float(deg.mean()), N=g.N,
         node_slack=replicas, threshold=SKEW_THRESHOLD, counters=counters,
         mirror_report=rep, build_seconds=build_s, split_seconds=split_s)
    return g, g2, plan, assign


def _primaries(g, g2, plan, what):
    """The rows at which a split graph is read against its unsplit one:
    every real row of `g` keeps its index and is the primary of its
    vertex (replicas take padding rows), with the same `orig_id`."""
    import torch

    if not (torch.equal(plan.primary_mask, g.node_mask)
            and torch.equal(g2.orig_id[g.node_mask], g.orig_id[g.node_mask])):
        raise AssertionError(f"{what}: primaries are not the unsplit rows")
    return g.node_mask


def _skew_static(g2, plan, backend):
    """The mirrored static analytics through one backend: coreness (with
    its superstep count), CC, PageRank (30 steps, tol=None), triangles
    (with `run_common_mirror`'s host seconds) and `fused_analytics`
    warm-started from the coreness and labels.  Returns {name: value,
    "seconds": the path's host seconds}."""
    import torch
    from repro_torch.core import (
        connected_components, fused_analytics, pagerank, triangle_counts)
    from repro_torch.core.algorithms import CorenessBlockProgram
    from repro_torch.kernels import ops

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = {}
    est, r["core_steps"] = ops.run_block_program(
        g2, CorenessBlockProgram(), backend=backend, mirror=plan,
        with_steps=True)
    r["core"] = torch.where(g2.node_mask, est, 0)
    r["labels"], r["cc_steps"] = connected_components(
        g2, backend=backend, mirror=plan, with_steps=True)
    r["rank"] = pagerank(g2, tol=None, max_steps=30, backend=backend,
                         mirror=plan)
    torch.cuda.synchronize()
    t = time.perf_counter()
    r["tri"] = triangle_counts(g2, backend=backend, mirror=plan)
    torch.cuda.synchronize()
    r["run_common_mirror_seconds"] = time.perf_counter() - t
    r["fused"] = fused_analytics(g2, steps=30, backend=backend,
                                 init=(r["core"], r["labels"]), mirror=plan)
    torch.cuda.synchronize()
    r["seconds"] = time.perf_counter() - t0
    return r


def _canonical_rows(g2, plan):
    """`run_common_mirror`'s canonical rows on the device: every stored
    serving-row id mapped to its primary, each row sorted, pads right."""
    import torch

    big = torch.iinfo(torch.int32).max
    prow = plan.primary_row.long()
    ids = torch.where(g2.nbr >= 0, prow[g2.nbr.clamp(min=0).long()].int(),
                      big).sort(dim=1).values
    return torch.where(ids == big, -1, ids)


def _skew_parity(g2, plan, r):
    """`ell_hindex`, `ell_cc`, `ell_pagerank`, `ell_multi`, `ell_triangles`
    and `kcore_hindex` against their plain versions on the split graph's
    rows and on the canonical rows, with the row lengths `deg` and
    without, on the mirrored run's fields `r` and random ones; bit-equal
    but the float sum (SUM_TOL).  Returns {kernel: max |kernel - plain|}."""
    import numpy as np
    import torch
    from repro_torch.core.algorithms import INT32_MAX, PageRankProgram
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.ell_hindex import hindex_ell, hindex_ell_plain
    from repro_torch.kernels.kcore_hindex import (
        hindex_counts, hindex_counts_plain)

    dev, N = g2.device, g2.N
    gen = torch.Generator(device=dev).manual_seed(20)
    rng = np.random.default_rng(20)
    ests = {"coreness": r["core"], "ldeg": plan.ldeg,
            "random": torch.randint(-2, plan.Km + 10, (N,), generator=gen,
                                    device=dev, dtype=torch.int32)}
    ints = {"cc_labels": torch.where(g2.node_mask, r["labels"], INT32_MAX),
            "random": torch.randint(-5, N + 5, (N,), generator=gen,
                                    device=dev, dtype=torch.int32)}
    floats = {"pagerank_contrib": PageRankProgram._contrib(plan.ldeg,
                                                           r["rank"]),
              "random": torch.rand(N, generator=gen, device=dev)}
    err = {"ell_hindex": 0, "kcore_hindex": 0}
    cases = []
    for rn, nb in (("split", g2.nbr), ("canonical", _canonical_rows(g2, plan))):
        for (en, est), d in ((e, d) for e in ests.items()
                             for d in (None, g2.deg)):
            got, want = hindex_ell(nb, est, deg=d), hindex_ell_plain(nb, est)
            torch.cuda.synchronize()
            e = int((got.long() - want.long()).abs().max())
            err["ell_hindex"] = max(err["ell_hindex"], e)
            if e:
                raise AssertionError(f"skew_egofb: ell_hindex differs from "
                                     f"plain on the {rn} rows, est={en}")
        cases.append(f"hindex/{rn}")
        cases += _min_sum_parity(nb, g2.deg, None, ints, floats,
                                 f"skew/{rn}", err)
        fields = {"hindex": r["core"], "min": ints["cc_labels"],
                  "sum": floats["pagerank_contrib"]}
        cases += _fused_parity(nb, g2.deg, None, fields,
                               _dup_field(tuple(nb.shape), rng, dev),
                               f"skew/{rn}", err)
    adj = ref.ell_to_dense(g2.nbr, N)
    for (en, est), K in ((e, k) for e in ests.items()
                         for k in (g2.Cd + 1, ops.degree_bound(g2) + 1)):
        got, want = hindex_counts(adj, est, K), hindex_counts_plain(adj, est, K)
        torch.cuda.synchronize()
        e = int((got.long() - want.long()).abs().max())
        err["kcore_hindex"] = max(err["kcore_hindex"], e)
        if e:
            raise AssertionError(f"skew_egofb: kcore_hindex differs from "
                                 f"plain, est={en} K={K}")
    cases.append("kcore_hindex/split")
    del adj
    torch.cuda.empty_cache()
    return err, cases


def _merge_timing(g2, plan, r):
    """Device ms of one mirror merge per combine at this graph's shapes
    (`tools/mirror_merge_timing.merge_ms`: `ops._mirror_merge` over the
    plan's `group_layout`, the h-index through the `mirror_hindex` kernel
    and its plain version beside it), and of the JAX package's (Rp, Cd,
    Km) comparison cube for the h-index, written out in PyTorch for the
    record (equal results checked)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.mirror_hindex import group_layout

    sys.path.insert(0, str(ROOT / "tools"))
    from mirror_merge_timing import merge_ms

    layout = group_layout(plan)
    out = merge_ms(g2, plan, layout, {
        "hindex": (r["core"], r["core"]), "min": (r["labels"], r["labels"]),
        "sum": (r["rank"], r["rank"])}, reps=20)

    def cube():
        rows, gid, G = plan.grp_rows.long(), plan.grp_gid.long(), plan.Gmax
        live = gid < G
        rn = g2.nbr[rows].long()
        ve = torch.where(rn >= 0, r["core"].long()[rn.clamp(min=0)], -1)
        t = torch.arange(1, plan.Km + 1, device=ve.device)
        hist = (ve[:, :, None] >= t[None, None, :]).sum(dim=1)
        hist = torch.where(live[:, None], hist, 0)
        cnt = torch.zeros((G + 1, plan.Km), dtype=hist.dtype,
                          device=ve.device).index_add_(0, gid, hist)
        h = (cnt >= t[None, :]).sum(dim=1)[gid]
        return r["core"].index_put((rows[live],), h[live].int())

    if not torch.equal(cube(), ops._mirror_merge(
            r["core"], r["core"], g2.nbr, plan, "hindex", deg=g2.deg,
            layout=layout)):
        raise AssertionError("skew_egofb: the h-index merge differs from "
                             "the comparison cube")
    out["hindex_cube_ms"] = _time_ms(cube, reps=5, warmup=1)
    return out


def skew_phase(g, g2, plan, assign, card):
    """skew_egofb (module docstring, phase 9): the mirrored static
    analytics, the mirrored stream and the service over it on the split
    ego-Facebook graph.  Returns the kernels' parity errors there."""
    import torch
    from repro_torch.core import (
        connected_components, coreness, pagerank, triangle_counts)

    what = "skew_egofb"
    prim = _primaries(g, g2, plan, what)
    e, launches = _counted(lambda: _skew_static(g2, plan, "ell"),
                           SKEW_KERNELS)
    p = _skew_static(g2, plan, "torch")
    for k in ("core", "labels", "tri"):
        if not torch.equal(e[k], p[k]):
            raise AssertionError(f"{what}: ell and plain {k} differ")
    for k in ("core_steps", "cc_steps"):
        if e[k] != p[k]:
            raise AssertionError(f"{what}: {k} {e[k]} (ell) vs {p[k]}")
    _close(e["rank"], p["rank"], f"{what} pagerank")
    for r in (e, p):  # fused == standalone, bit for bit, per backend
        fc, fl, fr = r["fused"]
        if not (torch.equal(fc, r["core"]) and torch.equal(fl, r["labels"])
                and torch.equal(fr, r["rank"])):
            raise AssertionError(f"{what}: fused != standalone")
    (dense_core, dense_steps), dense_launches = _counted(
        lambda: _dense_mirrored_coreness(g2, plan), ("kcore_hindex",))
    if not torch.equal(dense_core, e["core"]) or dense_steps != e["core_steps"]:
        raise AssertionError(f"{what}: dense mirrored coreness differs")
    unsplit = {"core": coreness(g, backend="ell"),
               "labels": connected_components(g, backend="ell"),
               "tri": triangle_counts(g, backend="ell"),
               "rank": pagerank(g, tol=None, max_steps=30, backend="ell")}
    for k in ("core", "labels", "tri"):
        if not torch.equal(e[k][prim], unsplit[k][prim]):
            raise AssertionError(f"{what}: split {k} != unsplit at primaries")
    rank_err = float((e["rank"][prim] - unsplit["rank"][prim]).abs().max())
    if rank_err > SKEW_RANK_ATOL:
        raise AssertionError(f"{what}: split PageRank off by {rank_err}")
    host = _scipy_check(g, torch.where(prim, e["labels"], -1),
                        torch.where(prim, e["tri"], 0), what)
    secs = {}
    for name, fn in (("coreness_split", lambda: coreness(
            g2, backend="ell", mirror=plan)),
            ("coreness_unsplit", lambda: coreness(g, backend="ell"))):
        fn()  # the warm-up call
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
    err, cases = _skew_parity(g2, plan, e)
    merge = _merge_timing(g2, plan, e)
    emit(phase=what, core_steps=e["core_steps"], cc_steps=e["cc_steps"],
         max_core=int(e["core"].max()),
         components=int(torch.unique(e["labels"][prim]).numel()),
         triangles=host["triangles"], rank_max_abs_err_vs_unsplit=rank_err,
         launches=launches, dense_launches=dense_launches,
         ell_coreness_seconds=secs,
         merge_device_ms_per_superstep=merge,
         run_common_mirror_host_seconds={
             "ell": e["run_common_mirror_seconds"],
             "torch": p["run_common_mirror_seconds"]},
         path_seconds={"ell": e["seconds"], "torch": p["seconds"]},
         parity_cases=cases, max_abs_err=err, card=card)
    ups = _skew_windows(g2, plan)
    _skew_stream(g, g2, plan, assign, ups, card)
    _skew_service(g2, plan, ups, card)
    return err


def _dense_mirrored_coreness(g2, plan):
    """Mirrored coreness on "dense" (the `kcore_hindex` kernel over the
    split graph's (N, N) bf16 adjacency) and its superstep count."""
    import torch
    from repro_torch.core.algorithms import CorenessBlockProgram
    from repro_torch.kernels import ops

    est, steps = ops.run_block_program(
        g2, CorenessBlockProgram(), backend="dense", mirror=plan,
        with_steps=True)
    return torch.where(g2.node_mask, est, 0), steps


def _logical_edges(g2, plan):
    """The split graph's edges between primary rows, (u < v) pairs."""
    import numpy as np

    nbr = g2.nbr.cpu().numpy()
    prow = plan.primary_row.cpu().numpy()
    rows, cols = np.nonzero(nbr >= 0)
    a, b = prow[rows], prow[nbr[rows, cols]]
    keep = a < b
    return set(zip(a[keep].tolist(), b[keep].tolist()))


def _skew_windows(g2, plan):
    """The mirrored stream's windows of R, in open-time primary-row ids:
    bench_skew's hub window (8 inserts onto the heaviest hub), inserts
    pushing SKEW_SPLITS vertices of degree 57..64 one past the threshold
    (on-line splits), SKEW_DELETES deletes of hub-incident edges, and
    their re-inserts.  Returns {"pre": [...], "deletes": [...],
    "reinserts": [...]} (lists of windows)."""
    import numpy as np

    rng = np.random.default_rng(SKEW_SEED)
    pm = plan.primary_mask.cpu().numpy()
    ldeg = plan.ldeg.cpu().numpy().astype(np.int64)
    cur = _logical_edges(g2, plan)
    hub = int(np.argmax(np.where(pm, ldeg, -1)))
    have = {v for e in cur if hub in e for v in e}
    prim = np.flatnonzero(pm)
    ins = [(hub, int(v), +1) for v in prim if int(v) not in have][:R]
    deg = np.zeros(len(pm), np.int64)
    for u, v in cur:
        deg[u] += 1
        deg[v] += 1
    for u, v, _ in ins:
        deg[u] += 1
        deg[v] += 1
        cur.add((min(u, v), max(u, v)))
    t = SKEW_THRESHOLD
    cands = prim[(deg[prim] >= t - 7) & (deg[prim] <= t)]
    grow = sorted(int(x) for x in rng.choice(cands, SKEW_SPLITS,
                                            replace=False))
    for x in grow:
        while deg[x] <= t:
            v = int(rng.choice(prim))
            e = (min(x, v), max(x, v))
            if v == x or v in grow or e in cur:
                continue
            cur.add(e)
            deg[x] += 1
            deg[v] += 1
            ins.append((x, v, +1))
    hubs = set(np.flatnonzero(
        pm & (plan.row_gid.cpu().numpy() < plan.Gmax)).tolist())
    incident = sorted(e for e in cur if e[0] in hubs or e[1] in hubs)
    pick = rng.choice(len(incident), SKEW_DELETES, replace=False)
    dels = [(incident[i][0], incident[i][1], -1) for i in pick]

    def chunks(ups):
        return [ups[i:i + R] for i in range(0, len(ups), R)]

    return {"pre": chunks(ins), "deletes": chunks(dels),
            "reinserts": chunks([(u, v, +1) for u, v, _ in dels]),
            "split_vertices": grow, "hub": hub}


def _session_state(sess):
    """A MirrorStream's state as clones: graph, plan, core, labels, stats."""
    from repro_torch.core.hub_split import MirrorPlan

    g, p = sess.g, sess.mirror
    out = {f"g.{f}": getattr(g, f).clone()
           for f in ("nbr", "deg", "node_mask", "orig_id")}
    out.update({f"plan.{f}": getattr(p, f).clone() for f in MirrorPlan.ARRAYS})
    out.update(core=sess.core.clone(), labels=sess.labels.clone(),
               stats=tuple(sess.result().stats),
               statics=(g.P, g.Cn, g.Cd, p.Gmax, p.Km, p.threshold,
                        p.n_logical))
    return out


def _same_state(a, b):
    import torch

    return all(torch.equal(a[k], b[k]) if isinstance(a[k], torch.Tensor)
               else a[k] == b[k] for k in a)


def _skew_run(g2, plan, ups, backend, on_window):
    """The mirrored stream's steps on a fresh MirrorStream: the "pre" and
    "deletes" windows, `grow(Cn=2·Cn)`, `save_session` and
    `restore_session` through a CheckpointManager in a temporary
    directory, then the re-inserts on the restored session.
    `on_window(i, session)` runs after every window.  Returns (session,
    {"save_seconds", "restore_seconds", "snapshot_bytes", "seconds"})."""
    import tempfile
    import torch
    from repro_torch.checkpoint import (
        CheckpointManager, restore_session, save_session)
    from repro_torch.runtime import MirrorStream

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sess = MirrorStream(g2, plan, backend=backend, cc_labels=True,
                        auto_grow=True)
    i, info = 0, {}
    for w in ups["pre"] + ups["deletes"]:
        sess.apply_window(w)
        on_window(i, sess)
        i += 1
    sess.grow(Cn=2 * sess.g.Cn)
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        t = time.perf_counter()
        step = save_session(mgr, sess)
        info["save_seconds"] = time.perf_counter() - t
        info["snapshot_bytes"] = sum(
            f.stat().st_size for f in (Path(d) / f"step_{step:08d}").iterdir())
        t = time.perf_counter()
        _, sess, _ = restore_session(mgr, device=g2.device)
        torch.cuda.synchronize()
        info["restore_seconds"] = time.perf_counter() - t
    for w in ups["reinserts"]:
        sess.apply_window(w)
        on_window(i, sess)
        i += 1
    torch.cuda.synchronize()
    info["seconds"] = time.perf_counter() - t0
    return sess, info


def _skew_stream(g, g2, plan, assign, ups, card):
    """The mirrored stream (module docstring, phase 9) on "ell" and
    "torch": after every window core and labels equal a fresh mirrored
    recompute and, at primaries in original ids, the unsplit recompute
    of the same edge set; the two runs hold equal graphs, plans, core,
    labels and stats."""
    import numpy as np
    import torch
    from repro_torch.core import (
        GraphBlocks, build_blocks, connected_components, coreness)
    from repro_torch.core import hub_split

    what = "skew_egofb_stream"
    states = []
    orig0 = g2.orig_id.cpu().numpy()
    n = int(g.orig_id.max()) + 1
    windows = ups["pre"] + ups["deletes"] + ups["reinserts"]
    with _host_timed(hub_split, ("apply_mirrored_edits",)) as host:
        (sess, info), launches = _counted(
            lambda: _skew_run(g2, plan, ups, "ell",
                              lambda i, s: states.append(_session_state(s))),
            ("ell_hindex", "ell_cc"))
    # the ell run against a fresh recompute and the unsplit graph
    cur = _logical_edges(g2, plan)
    for i, (w, st) in enumerate(zip(windows, states)):
        for u, v, op in w:
            e = (min(u, v), max(u, v))
            (cur.add if op > 0 else cur.discard)(e)
        gi = GraphBlocks(nbr=st["g.nbr"], deg=st["g.deg"],
                         node_mask=st["g.node_mask"], orig_id=st["g.orig_id"],
                         P=g2.P, Cn=st["statics"][1], Cd=st["statics"][2])
        pi = hub_split.MirrorPlan(
            **{f: st[f"plan.{f}"] for f in hub_split.MirrorPlan.ARRAYS},
            Gmax=st["statics"][3], Km=st["statics"][4],
            threshold=st["statics"][5], n_logical=st["statics"][6], uid=0)
        if not (torch.equal(coreness(gi, backend="ell", mirror=pi), st["core"])
                and torch.equal(connected_components(
                    gi, backend="ell", mirror=pi), st["labels"])):
            raise AssertionError(f"{what}: window {i}: core/labels != a "
                                 "fresh mirrored recompute")
        edges = np.array(sorted(cur), np.int64)
        gu = build_blocks(orig0[edges], n, assign, P=g.P, device=g.device)
        ucore = coreness(gu, backend="ell")
        ulab = connected_components(gu, backend="ell")
        pm = pi.primary_mask
        oid = gi.orig_id
        split = (oid[pm], st["core"][pm], oid[st["labels"][pm].long()])
        um = gu.node_mask
        ref_ = (gu.orig_id[um], ucore[um], gu.orig_id[ulab[um].long()])
        os_, ou = split[0].argsort(), ref_[0].argsort()
        if not all(torch.equal(a[os_], b[ou]) for a, b in zip(split, ref_)):
            raise AssertionError(f"{what}: window {i}: core/labels != the "
                                 "unsplit recompute at primaries")
    stats = sess.result().stats
    if stats.grows != 1 or stats.batches != len(windows):
        raise AssertionError(f"{what}: expected one grow over "
                             f"{len(windows)} windows: {stats}")
    n_groups0 = plan.n_groups

    def check_plain(i, s):
        if not _same_state(_session_state(s), states[i]):
            raise AssertionError(f"{what}: window {i}: the torch run differs "
                                 "from the ell run")

    _, info_p = _skew_run(g2, plan, ups, "torch", check_plain)
    ms = [1e3 * s for s in host["apply_mirrored_edits"]]
    emit(phase=what, windows=len(windows), updates=stats.updates,
         split_vertices=ups["split_vertices"], hub=ups["hub"],
         groups={"open": n_groups0, "end": sess.mirror.n_groups},
         N={"open": g2.N, "end": sess.g.N}, stream_stats=stats._asdict(),
         launches=launches,
         apply_mirrored_edits_ms={"median": statistics.median(ms),
                                  "max": max(ms), "calls": len(ms)},
         path_seconds={"ell": info["seconds"], "torch": info_p["seconds"]},
         save_seconds=info["save_seconds"],
         restore_seconds=info["restore_seconds"],
         snapshot_bytes=info["snapshot_bytes"], card=card)


def _mirror_oracles(snaps):
    """For each epoch (snapshot, graph, plan): a mirrored recompute on
    "ell" held against the snapshot (core, labels, ranks bit for bit,
    logical degrees, the primary map, and `nbr_max` against the max
    coreness over each vertex's logical neighborhood on the host), then
    the answer arrays read through the primary map."""
    import numpy as np
    import torch
    from repro_torch.core import connected_components, coreness, pagerank

    out = {}
    for epoch, (snap, g, plan) in sorted(snaps.items()):
        core = coreness(g, backend="ell", mirror=plan)
        fields = {
            "core": core,
            "labels": connected_components(g, backend="ell", mirror=plan),
            "rank": torch.where(plan.primary_mask, pagerank(
                g, alpha=SERVICE_CONFIG["alpha"], tol=None,
                max_steps=SERVICE_CONFIG["pr_steps"], backend="ell",
                mirror=plan), 0.0),
            "deg": plan.ldeg}
        for k, v in fields.items():
            if not torch.equal(v, getattr(snap, k)):
                raise AssertionError(f"skew_egofb_service: epoch {epoch} "
                                     f"snapshot {k} != recompute")
        host = {k: v.cpu().numpy() for k, v in fields.items()}
        prow = plan.primary_row.cpu().numpy().astype(np.int64)
        nbr = g.nbr.cpu().numpy()
        vals = np.where(nbr >= 0, host["core"][prow[np.maximum(nbr, 0)]], -1)
        best = np.full(g.N, -1, np.int64)
        np.maximum.at(best, prow, vals.max(axis=1))
        if not (np.array_equal(snap.nbr_max.cpu().numpy(), best[prow])
                and np.array_equal(snap.primary, prow)):
            raise AssertionError(f"skew_egofb_service: epoch {epoch} nbr_max "
                                 "or primary != the logical neighborhood's")
        res = {k: v[prow] for k, v in host.items() if k != "rank"}
        res["nbr_max"] = best[prow]
        res["rank"] = host["rank"]
        res["order"] = np.lexsort((np.arange(g.N), -host["rank"]))[
            :SERVICE_TOPK_MAX]
        out[epoch] = res
    return out


def _skew_service(g2, plan, ups, card):
    """The query service over a fresh MirrorStream on "ell": SERVICE_CONFIG,
    the `mixed` mix (SERVICE_QPW queries before each window, ids in
    [0, N), replica rows among them) over the stream's first
    SKEW_SERVICE_WINDOWS windows.  Every snapshot equals its epoch's
    mirrored recompute and every answer that recompute's, read through
    the primary map."""
    import numpy as np
    import torch
    import repro_torch.service as svc
    from repro_torch.runtime import MirrorStream

    what = "skew_egofb_service"
    windows = (ups["pre"] + ups["deletes"])[:SKEW_SERVICE_WINDOWS]

    def run():
        sess = MirrorStream(g2, plan, backend="ell", cc_labels=True)
        srv = svc.QueryServer(sess, config=svc.ServiceConfig(**SERVICE_CONFIG))
        snaps = {0: (srv.state.snapshot, sess.g, sess.mirror)}
        refresh, requests, secs = srv.state.refresh, [], []

        def recorded_refresh():
            torch.cuda.synchronize()
            t = time.perf_counter()
            snap = refresh()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t)
            snaps[snap.epoch] = (snap, sess.g, sess.mirror)
            return snap

        srv.state.refresh = recorded_refresh
        rng = np.random.default_rng(SERVICE_SEED)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for w in windows:
            for q in _mix_mixed(svc, rng, g2.N, SERVICE_QPW):
                requests.append(srv.submit(q))
            srv.step(w)
        srv.pump()
        torch.cuda.synchronize()
        return srv, snaps, requests, secs, time.perf_counter() - t0

    (srv, snaps, requests, secs, seconds), launches = _counted(
        run, ("ell_multi", "ell_hindex", "ell_cc"))
    oracles = _mirror_oracles(snaps)
    _check_service_answers(requests, oracles, what)
    replicas = set(np.flatnonzero(
        (g2.node_mask & ~plan.primary_mask).cpu().numpy()).tolist())
    asked = sum(r.query.u in replicas for r in requests
                if r.query.kind != "topk_pagerank")
    if not asked:
        raise AssertionError(f"{what}: no query asked at a replica row")
    s = srv.metrics.summary()
    if s["shed"]:
        raise AssertionError(f"{what}: {s['shed']} queries shed")
    emit(phase=what, windows=len(windows), queries_per_window=SERVICE_QPW,
         answers_checked=len(requests), answers_at_replica_rows=asked,
         epochs=len(oracles),
         **{k: s[k] for k in ("p50_ms", "p99_ms", "qps", "answered",
                              "batches", "staleness_max")},
         refresh_seconds_mean=sum(secs) / len(secs),
         refresh_seconds_max=max(secs), path_seconds=seconds,
         launches=launches, card=card)


def scale_phase(dev):
    """A 2^21-node random ELL graph: the main path and the analytics
    through the kernels, held against the plain backend; then `ell_cc`,
    `ell_pagerank`, `ell_multi`, `ell_triangles` and the two variants timed
    there (`_deg_timing`; its nbr, 256 MiB, does not fit the 50 MB L2).
    Returns those timings."""
    import torch
    from repro_torch.core import build_ell_random
    from repro_torch.core.algorithms import INT32_MAX, PageRankProgram

    t0 = time.perf_counter()
    g = build_ell_random(2 ** SCALE_LOG2_N, Cd=32, seed=0, m_factor=4.0,
                         device=dev)
    ups = sample_stream(g, SCALE_UPDATES // 2, seed0=6, scenarios=("intra",))
    emit(phase="scale_graph", N=g.N, Cd=g.Cd, nbr_bytes=g.nbr.numel() * 4,
         max_degree=int(g.deg.max()), host_seconds=time.perf_counter() - t0)
    _drive(g, ups, "scale_random_2^%d" % SCALE_LOG2_N)
    _, fields, _ = _analytics(g, "analytics_scale_2^%d" % SCALE_LOG2_N)
    lab = torch.where(g.node_mask, fields["labels"], INT32_MAX)
    contrib = PageRankProgram._contrib(g.deg, fields["rank"])
    # the h-index field is est = degrees, the static fixpoint's first step
    shapes = _deg_timing(g, (g.deg, lab, contrib), _launch_floor_ms(dev))
    emit(phase="scale_timing", order="without deg, with deg, with deg, "
         "without deg", shapes=shapes)
    return shapes


def _close(a, b, what, tol=RANK_TOL):
    import torch

    if not torch.allclose(a, b, **tol):
        err = float((a - b).abs().max())
        raise AssertionError(f"{what}: ell and plain differ by {err}")


def analytics_path(gc, backend, core=None, ups=None):
    """The BlockProgram workloads on graph `gc` through one backend:
    connected components, PageRank (30 fixed supersteps) and triangle
    counts; with `core` (the coreness of `gc`) also PageRank with
    tol = 1e-6 and the coreness program; with `ups` too, `fused_analytics`
    warm-started from the coreness and the labels, and `run_stream` with CC
    maintenance, which updates `gc` in place, last.  Returns {result name:
    value, "seconds": host seconds of the whole path, ending in a
    synchronize}."""
    import torch
    from repro_torch.core import (
        connected_components, fused_analytics, pagerank, triangle_counts)
    from repro_torch.core.algorithms import CorenessBlockProgram
    from repro_torch.kernels import ops
    from repro_torch.runtime import run_stream

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = {}
    r["labels"], r["cc_steps"] = connected_components(
        gc, backend=backend, with_steps=True)
    r["rank"], r["pr_steps"] = pagerank(gc, tol=None, max_steps=30,
                                        backend=backend, with_steps=True)
    r["tri"] = triangle_counts(gc, backend=backend)
    if core is not None:
        r["rank_tol"], r["pr_tol_steps"] = pagerank(
            gc, tol=1e-6, backend=backend, with_steps=True)
        r["core"], r["core_steps"] = ops.run_block_program(
            gc, CorenessBlockProgram(), backend=backend, with_steps=True)
    if ups is not None:
        r["fused"] = fused_analytics(gc, steps=30, backend=backend,
                                     init=(r["core"], r["labels"]))
        r["stream"] = run_stream(gc, core.clone(), ups, R=R,
                                 backend=backend, cc_labels=r["labels"])
    torch.cuda.synchronize()
    r["seconds"] = time.perf_counter() - t0
    return r


def _analytics(g, what, core=None, ups=None):
    """The BlockProgram workloads through the kernels, held against the
    same programs on the plain backend; each path runs on its own copy of
    `g`.  With `core` and `ups` (the DS1 phase) also the coreness program,
    `fused_analytics` warm-started from it and the CC labels, PageRank
    with a tolerance, the stream with CC maintenance, and scipy's host
    check.  Returns ({kernel: launches} of the ell run, {field name:
    tensor} for the timing phase, the plain run's results)."""
    import torch
    from repro_torch.core import connected_components

    full = core is not None
    names = (tuple(k for k in KERNELS if k not in DENSE + VARIANTS) if full
             else ("ell_cc", "ell_pagerank", "ell_triangles"))
    e, launches = _counted(
        lambda: analytics_path(g.clone(), "ell", core, ups), names)
    p = analytics_path(g.clone(), "torch", core, ups)
    for k in ("labels", "tri") + (("core",) if full else ()):
        if not torch.equal(e[k], p[k]):
            raise AssertionError(f"{what}: ell and plain {k} differ")
    for k in ("cc_steps", "pr_steps") + (("core_steps",) if full else ()):
        if e[k] != p[k]:
            raise AssertionError(f"{what}: {k} {e[k]} (ell) vs {p[k]}")
    if e["pr_steps"] != 30:
        raise AssertionError(f"{what}: {e['pr_steps']} PageRank supersteps")
    _close(e["rank"], p["rank"], f"{what} pagerank(tol=None)")
    line = dict(phase=what, cc_steps=e["cc_steps"],
                components=int(torch.unique(e["labels"][g.node_mask]).numel()),
                pr_steps=e["pr_steps"],
                triangles=int(e["tri"].sum()) // 3, launches=launches,
                path_seconds=e["seconds"], plain_path_seconds=p["seconds"])
    if full:
        _close(e["rank_tol"], p["rank_tol"], f"{what} pagerank(tol=1e-6)")
        mask = g.node_mask
        if not torch.equal(torch.where(mask, e["core"], 0), core):
            raise AssertionError(f"{what}: coreness program != coreness")
        for r in (e, p):  # fused == standalone, bit for bit, per backend
            fc, fl, fr = r["fused"]
            if not (torch.equal(fc, r["core"]) and torch.equal(fl, r["labels"])
                    and torch.equal(fr, r["rank"])):
                raise AssertionError(f"{what}: fused != standalone")
        _check_same_stream(e["stream"], p["stream"], what)
        st = e["stream"].stats
        if not (torch.equal(e["stream"].labels, p["stream"].labels)
                and st.cc_merges > 0 and st.cc_recomputes > 0):
            raise AssertionError(f"{what}: stream CC labels or counts: {st}")
        fresh = connected_components(e["stream"].g, backend="ell")
        if not torch.equal(fresh, e["stream"].labels):
            raise AssertionError(f"{what}: maintained labels != recompute")
        line.update(pr_tol_steps={"ell": e["pr_tol_steps"],
                                  "torch": p["pr_tol_steps"]},
                    core_steps=e["core_steps"],
                    stream_stats=st._asdict(),
                    host_check=_scipy_check(g, e["labels"], e["tri"], what))
    emit(**line)
    fields = {"labels": e["labels"], "rank": e["rank"],
              "core": e.get("core")}
    return launches, fields, p


def _analytics_dense(g, p):
    """CC, PageRank (30 fixed supersteps; tol = 1e-6), triangles and the
    coreness program with backend="dense" on a copy of `g`, held against
    the plain run `p` (as `_analytics` returns it): equal labels,
    triangles, coreness and superstep counts; ranks allclose at RANK_TOL.
    The coreness program must launch `kcore_hindex`."""
    import torch

    what = "analytics_ds1_dense"
    torch.cuda.reset_peak_memory_stats()
    e, launches = _counted(
        lambda: analytics_path(g.clone(), "dense", core=p["core"]),
        ("kcore_hindex",))
    for k in ("labels", "tri", "core"):
        if not torch.equal(e[k], p[k]):
            raise AssertionError(f"{what}: dense and plain {k} differ")
    for k in ("cc_steps", "pr_steps", "core_steps"):
        if e[k] != p[k]:
            raise AssertionError(f"{what}: {k} {e[k]} (dense) vs {p[k]}")
    _close(e["rank"], p["rank"], f"{what} pagerank(tol=None)")
    _close(e["rank_tol"], p["rank_tol"], f"{what} pagerank(tol=1e-6)")
    emit(phase=what, cc_steps=e["cc_steps"], pr_steps=e["pr_steps"],
         pr_tol_steps={"dense": e["pr_tol_steps"], "torch": p["pr_tol_steps"]},
         core_steps=e["core_steps"], triangles=int(e["tri"].sum()) // 3,
         rank_max_abs_err=float((e["rank"] - p["rank"]).abs().max()),
         launches=launches,
         peak_device_bytes=torch.cuda.max_memory_allocated(),
         path_seconds=e["seconds"])


def variants_phase(g, core, steps, tri):
    """The two kernel variants through their entry points on DS1, with the
    row lengths `deg` as the default paths pass them:
    `coreness_blocks(variant="count")` (which hands `g.deg` on) against the
    plain coreness `core` (found in `steps` supersteps) and
    `neighbor_common_ell(variant="allpairs", deg=g.deg)` against "merge",
    the plain triangle counts `tri` and scipy.  Returns the variants'
    launch counts."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.ell_triangles import neighbor_common_ell

    what = "variants_ds1"

    def path():
        c, s = ops.coreness_blocks(g, backend="ell", with_steps=True,
                                   variant="count")
        return c, s, neighbor_common_ell(g.nbr, g.nbr, variant="allpairs",
                                         deg=g.deg)

    (c, s, red), launches = _counted(path, VARIANTS)
    if s != steps or not torch.equal(c, core):
        raise AssertionError(f"{what}: count-variant coreness differs "
                             f"({s} vs {steps} supersteps)")
    if not (torch.equal(red, neighbor_common_ell(g.nbr, g.nbr, deg=g.deg))
            and torch.equal(red // 2, tri)):
        raise AssertionError(f"{what}: allpairs differs from merge or plain")
    closed = _closed_walks(g)
    if not np.array_equal(closed, red.cpu().numpy()):
        raise AssertionError(f"{what}: allpairs differs from scipy")
    emit(phase=what, count_steps=s, triangles=int(closed.sum() / 6),
         launches=launches)
    return launches


def _scipy_check(g, labels, tri, what):
    """CC and triangles against scipy on the host, from the edge list:
    the same partition of the real nodes; per-node triangles diag(A^3)/2
    and the total trace(A^3)/6."""
    import numpy as np
    from scipy.sparse.csgraph import connected_components as sp_cc

    A = _host_adjacency(g)
    _, sp_lab = sp_cc(A, directed=False)
    mask = g.node_mask.cpu().numpy()
    ours = labels.cpu().numpy()[mask]
    theirs = sp_lab[mask]
    pairs = len(set(zip(ours.tolist(), theirs.tolist())))
    if not pairs == len(set(ours.tolist())) == len(set(theirs.tolist())):
        raise AssertionError(f"{what}: CC partition differs from scipy")
    closed = _closed_walks(g)
    if not (np.array_equal(closed / 2, tri.cpu().numpy())
            and closed.sum() / 6 == int(tri.sum()) // 3):
        raise AssertionError(f"{what}: triangles differ from scipy")
    return {"components": pairs, "triangles": int(closed.sum() / 6)}


def _host_adjacency(g):
    """The graph's adjacency as a scipy CSR matrix on the host."""
    import numpy as np
    import scipy.sparse as sp

    nbr = g.nbr.cpu().numpy()
    rows, cols = np.nonzero(nbr >= 0)
    return sp.csr_matrix((np.ones(len(rows)), (rows, nbr[rows, cols])),
                         shape=(g.N, g.N))


def _closed_walks(g):
    """diag(A^3) per node by scipy: twice the triangles through it."""
    import numpy as np

    A = _host_adjacency(g)
    return np.asarray(A.multiply(A @ A).sum(axis=1)).ravel()


def _time_ms(fn, reps=20, warmup=3) -> float:
    """Median device milliseconds of one call, over `reps` calls.

    A CUDA event is recorded between consecutive calls.  The device is
    first held busy (`torch.cuda._sleep`) while the host queues all the
    calls, so the calls run back to back and each interval between two
    events is device time, not the host's launch overhead."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    torch.cuda._sleep(100_000_000)  # ~50 ms of device time
    ev[0].record()
    for i in range(reps):
        fn()
        ev[i + 1].record()
    ev[-1].synchronize()
    return statistics.median(ev[i].elapsed_time(ev[i + 1])
                             for i in range(reps))


def _bound_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def _time_pair(kernel, plain, plain_reps=20):
    """(kernel ms, plain ms) on one card, timed plain, kernel, kernel,
    plain; each is the smaller of its two medians.  A slow plain version
    takes fewer calls (`plain_reps`, after one warm-up call)."""
    kw = {} if plain_reps == 20 else dict(reps=plain_reps, warmup=1)
    p1 = _time_ms(plain, **kw)
    k1, k2 = _time_ms(kernel), _time_ms(kernel)
    return min(k1, k2), min(p1, _time_ms(plain, **kw))


def _launch_floor_ms(dev) -> float:
    """What any launch costs on this card: one one-element PyTorch op
    (`add_`) timed as a kernel, the smaller of two medians."""
    import torch

    one = torch.zeros(1, device=dev)
    return min(_time_ms(lambda: one.add_(1)) for _ in range(2))


def _csr(nbr, N):
    """The ELL adjacency as a torch CSR matrix of ones (for
    `torch.sparse.mm`, the library call beside the sum)."""
    import warnings

    import torch

    rows, cols = torch.nonzero(nbr >= 0, as_tuple=True)
    with warnings.catch_warnings():  # CSR support is "beta" in PyTorch
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_coo_tensor(
            torch.stack([rows, nbr[rows, cols].long()]),
            torch.ones(rows.numel(), device=nbr.device),
            (N, N)).to_sparse_csr()


def _deg_timing(g, fields, floor_ms):
    """The six kernels that take the row lengths, each as its entry point
    calls it on graph `g`: `ell_cc` on the min field, `ell_pagerank` on the
    sum field, `ell_multi` on fields (hindex, min, sum), the whole
    `ell_triangles` wrapper on rows = nbr, and the two variants,
    `ell_hindex_count` on the h-index field and `ell_allpairs` on rows =
    nbr, with the row lengths `deg` (`ms`) and without (`ms_without_deg`),
    in turns, beside the plain version (3 calls, not 20, for the all-pairs
    match's) and three bounds: the all-columns bound
    (`bound_ms_all_columns`: the first C = Cd columns of nbr, which a call
    without deg must read, with the fields and outputs), the row-length
    bound (`bound_ms_row_length`: every valid slot these inputs need read
    once, with deg, the fields and the outputs; for the triangles the field
    is nbr itself, so its valid slots are those bytes) and
    `launch_floor_ms`.  Operations, at the scalar rate: the triangles' one
    probe per (u, v, y) triple; the count variant's C compares per valid
    slot, and min(deg, C) with row lengths (h <= deg); the all-pairs
    match's |u's row| compares per valid element of each valid neighbour's
    row, which its compaction reaches, the same with row lengths.
    `ell_pagerank` also beside `torch.sparse.mm` of the CSR adjacency by
    the field (`library_ms`; the CSR is built outside the timed region).
    Returns {kernel: shape dict}."""
    import torch
    from repro_torch.kernels.ell_cc import (
        neighbor_min_ell, neighbor_min_ell_plain)
    from repro_torch.kernels.ell_hindex import (
        hindex_count_ell, hindex_count_ell_plain)
    from repro_torch.kernels.ell_multi import (
        neighbor_multi_ell, neighbor_multi_ell_plain)
    from repro_torch.kernels.ell_pagerank import (
        neighbor_sum_ell, neighbor_sum_ell_plain)
    from repro_torch.kernels.ell_triangles import (
        common_allpairs_ell, common_allpairs_ell_plain, neighbor_common_ell,
        neighbor_common_ell_plain)

    N, Cd, nbr, deg = g.N, g.Cd, g.nbr, g.deg
    hfield, lab, contrib = fields
    valid = nbr >= 0
    n_valid = int(valid.sum())
    rdeg = valid.sum(dim=1)
    nb_deg = torch.where(valid, rdeg[nbr.clamp(min=0).long()], 0).sum(dim=1)
    triples = int(nb_deg.sum())
    pair_ops = int((rdeg * nb_deg).sum())  # the compacted all-pairs match
    del nb_deg
    vec = N * 4
    combines = ("hindex", "min", "sum")
    runs = {
        # name: (call with deg or None, plain, all-columns bytes,
        #        row-length bytes, all-columns operations, row-length
        #        operations, plain calls timed)
        "ell_cc": (
            lambda d: neighbor_min_ell(nbr, lab, deg=d),
            lambda: neighbor_min_ell_plain(nbr, lab),
            N * Cd * 4 + 2 * vec, n_valid * 4 + vec + 2 * vec, 0, 0, 20),
        "ell_pagerank": (
            lambda d: neighbor_sum_ell(nbr, contrib, deg=d),
            lambda: neighbor_sum_ell_plain(nbr, contrib),
            N * Cd * 4 + 2 * vec, n_valid * 4 + vec + 2 * vec, 0, 0, 20),
        "ell_multi": (
            lambda d: neighbor_multi_ell(nbr, fields, combines, deg=d),
            lambda: neighbor_multi_ell_plain(nbr, fields, combines),
            N * Cd * 4 + 6 * vec, n_valid * 4 + vec + 6 * vec, 0, 0, 20),
        "ell_triangles": (
            lambda d: neighbor_common_ell(nbr, nbr, deg=d),
            lambda: neighbor_common_ell_plain(nbr, nbr),
            N * Cd * 4 + vec, n_valid * 4 + 2 * vec, triples, triples, 20),
        "ell_hindex_count": (
            lambda d: hindex_count_ell(nbr, hfield, deg=d),
            lambda: hindex_count_ell_plain(nbr, hfield),
            N * Cd * 4 + 2 * vec, n_valid * 4 + vec + 2 * vec, n_valid * Cd,
            int((rdeg * rdeg.clamp(max=Cd)).sum()), 20),
        "ell_allpairs": (
            lambda d: common_allpairs_ell(nbr, nbr, deg=d),
            lambda: common_allpairs_ell_plain(nbr, nbr),
            N * Cd * 4 + vec, n_valid * 4 + 2 * vec, pair_ops, pair_ops, 3),
    }
    out = {}
    for name, (call, plain, all_b, row_b, all_ops, row_ops,
               plain_reps) in runs.items():
        ms, ms_all = _time_pair(lambda: call(deg), lambda: call(None))
        kw = {} if plain_reps == 20 else dict(reps=plain_reps, warmup=1)
        plain_ms = min(_time_ms(plain, **kw) for _ in range(2))
        all_ops_ms = all_ops / SCALAR_OPS_PER_S * 1e3
        row_ops_ms = row_ops / SCALAR_OPS_PER_S * 1e3
        out[name] = dict(
            N=N, Cd=Cd, valid_slots=n_valid, ms=ms, ms_without_deg=ms_all,
            plain_ms=plain_ms, plain_calls_timed=plain_reps,
            bound_bytes_all_columns=all_b, bound_ops_all_columns=all_ops,
            bound_ms_all_columns=max(_bound_ms(all_b), all_ops_ms),
            bound_bytes_row_length=row_b, bound_ops=row_ops,
            bound_ms_row_length=max(_bound_ms(row_b), row_ops_ms),
            bound_by="bytes" if _bound_ms(row_b) >= row_ops_ms
            else "operations", launch_floor_ms=floor_ms)
    csr, x = _csr(nbr, N), contrib[:, None]
    out["ell_pagerank"]["library_ms"] = _time_ms(
        lambda: torch.sparse.mm(csr, x))
    out["ell_pagerank"]["library_max_abs_err_vs_kernel"] = float(
        (torch.sparse.mm(csr, x)[:, 0]
         - neighbor_sum_ell(nbr, contrib, deg=deg)).abs().max())
    del csr
    return out


def timing(g, core, window, parity, launches, hindex_split):
    """The kernel line: each kernel and its plain version at the main
    path's shapes.

    `ell_hindex` runs at two shapes.  The stream's clamped recompute
    (most launches) passes K = None (C = Cd columns, PAD may sit anywhere)
    with est = the coreness; the static fixpoint passes K = the degree
    bound with est = degrees.  `ell_frontier` is timed at the first hop of
    the stream's first window (R = 8, the kernel entry's shape) and at the
    first hop of its first update alone (R = 1, as the stream searches for
    the updates a batch defers).  Each is timed as the main path calls it,
    with the row lengths `deg` (`ms`), and without (`ms_without_deg`,
    every row read up to its C columns), in turns, beside two bounds that
    count every input read once and the output written once: the
    all-columns bound (`bound_ms`: the first C columns of every row a call
    without deg must read) and the row-length bound (`bound_ms_row_length`:
    only the slots these inputs need — a row's valid slots, for the
    frontier only in rows that need a column and up to the slot where its
    last needed column is first hit — with deg).  `launch_floor_ms` is one
    one-element PyTorch op (`add_`) timed the same way: what any launch
    costs on this card.  The kernel entries carry the main path's call:
    `ms` with deg, against the row-length bound."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.ell_frontier import (
        frontier_step_ell, frontier_step_ell_plain)
    from repro_torch.kernels.ell_hindex import (
        columns, hindex_ell, hindex_ell_plain)

    N, Cd, nbr, deg = g.N, g.Cd, g.nbr, g.deg
    floor_ms = _launch_floor_ms(g.device)
    io = N * 4 + N * 4  # est read once, out written once
    shapes = []
    for shape, est, K, n in (
            ("stream recompute: K=None, est=coreness", core, None,
             hindex_split["stream"]),
            ("static fixpoint: K=degree_bound, est=degrees", g.deg,
             ops.degree_bound(g), hindex_split["static"])):
        C = columns(Cd, K)
        ms, ms_all = _time_pair(lambda: hindex_ell(nbr, est, K=K, deg=deg),
                                lambda: hindex_ell(nbr, est, K=K))
        plain_ms = min(_time_ms(lambda: hindex_ell_plain(nbr, est, K))
                       for _ in range(2))
        valid = int((nbr[:, :C] >= 0).sum())
        s = {"shape": shape, "C": C, "launches": n, "ms": ms,
             "ms_without_deg": ms_all, "plain_ms": plain_ms,
             "valid_slots": valid, "bound_bytes": N * C * 4 + io,
             "bound_bytes_row_length": valid * 4 + N * 4 + io}
        s["bound_ms"] = _bound_ms(s["bound_bytes"])
        s["bound_ms_row_length"] = _bound_ms(s["bound_bytes_row_length"])
        shapes.append(s)

    fshapes = []
    for shape, hop in (("batch's first hop, R=8", window),
                       ("deferred update's first hop, R=1", window[:1])):
        f, elig, vis = _first_hop(g, core, hop)
        Rr = f.shape[1]
        # nbr slots this data needs, in slot order: none for a row that
        # needs no column; up to the slot where its last needed column is
        # first hit; when a needed column is never hit, all Cd (PAD may sit
        # anywhere) or, knowing the row's length, its valid slots
        need = elig & ~vis
        hits = f[nbr.clamp(min=0).long()] & (nbr >= 0)[:, :, None]
        first = hits.to(torch.int32).argmax(dim=1) + 1  # (N, R)
        found = hits.any(dim=1)
        del hits
        row_len = (nbr >= 0).sum(dim=1, dtype=torch.int32)[:, None]
        slots, slots_row = (
            int(torch.where(need, torch.where(found, first, miss), 0)
                .amax(dim=1).sum())
            for miss in (torch.full_like(first, Cd),
                         row_len.expand_as(first)))
        masks_b = 4 * N * Rr  # eligible, visited, f read; out written
        fb, fb_row = masks_b + slots * 4, masks_b + N * 4 + slots_row * 4
        fk, fk_all = _time_pair(
            lambda: frontier_step_ell(nbr, f, elig, vis, deg=deg),
            lambda: frontier_step_ell(nbr, f, elig, vis))
        fp = min(_time_ms(lambda: frontier_step_ell_plain(nbr, f, elig, vis))
                 for _ in range(2))
        fshapes.append(dict(
            shape=shape, N=N, Cd=Cd, R=Rr,
            rows_needing=int(need.any(dim=1).sum()), nbr_slots_needed=slots,
            nbr_slots_needed_row_length=slots_row, ms=fk,
            ms_without_deg=fk_all, plain_ms=fp, bound_bytes=fb,
            bound_ms=_bound_ms(fb), bound_bytes_row_length=fb_row,
            bound_ms_row_length=_bound_ms(fb_row)))
    emit(phase="timing", order="plain,kernel,kernel,plain; "
         "without deg, with deg, with deg, without deg",
         launch_floor_ms=floor_ms,
         launch_floor_op="one-element torch.Tensor.add_, timed as a kernel",
         hindex_shapes=shapes, frontier_shapes=fshapes)

    def entry(name, s):
        return {"name": name, "route": "cuda",
                "source": f"src/repro_torch/kernels/csrc/{name}.cu",
                "replaces": KERNELS[name][1], "launches": launches[name],
                "parity": "bit-equal", "max_abs_err": parity[name],
                "ms": s["ms"], "plain_ms": s["plain_ms"],
                "bound_ms": s["bound_ms_row_length"], "bound_by": "bytes",
                "bound_bytes": s["bound_bytes_row_length"],
                "library_ms": None, "ms_without_deg": s["ms_without_deg"],
                "bound_ms_all_columns": s["bound_ms"],
                "launch_floor_ms": floor_ms}

    return [dict(entry("ell_hindex", shapes[0]), shapes=shapes),
            dict(entry("ell_frontier", fshapes[0]), shapes=fshapes)]


def combine_timing(g, fields, parity, launches, floor_ms, scale):
    """The combine kernels and the two variants at the analytics shapes the
    runner gives them (K = None: every one of the Cd columns, PAD may sit
    anywhere), each beside its plain version: `ell_cc`, `ell_pagerank`,
    `ell_multi`, `ell_triangles` (the whole wrapper, rows = nbr),
    `ell_hindex_count` (on the coreness) and `ell_allpairs` (rows = nbr) as
    their entry points call them, with the row lengths `deg`, and without,
    beside the all-columns bound, the row-length bound and the launch floor
    `floor_ms` (`_deg_timing`; `ell_pagerank` also beside `torch.sparse.mm`
    of the CSR adjacency by the field), on DS1 and on the 2^21 scale graph
    (`scale`, from `scale_phase`).  The variants' launches are
    `variants_phase`'s."""
    import torch
    from repro_torch.core.algorithms import INT32_MAX, PageRankProgram

    N, Cd, nbr = g.N, g.Cd, g.nbr
    lab = torch.where(g.node_mask, fields["labels"], INT32_MAX)
    contrib = PageRankProgram._contrib(g.deg, fields["rank"])
    core = fields["core"]
    n_valid = int((nbr >= 0).sum())
    variant_extra = {
        "ell_hindex_count": {"ops_every_slot": N * Cd * Cd,
                             "sibling": "ell_hindex"},
        "ell_allpairs": {"ops_uncompacted": n_valid * Cd * Cd,
                         "sibling": "ell_triangles"}}
    multi_detail = {"parity_detail": "every output bit-equal to its "
                    "standalone kernel; min and hindex bit-equal to plain; "
                    "max_abs_err is the sum's against plain"}
    out, shapes = [], {}
    timed = _deg_timing(g, (core, lab, contrib), floor_ms)
    for name, s in timed.items():
        shapes[name] = {"ds1": s, "scale_2^%d" % SCALE_LOG2_N: scale[name]}
        out.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": KERNELS[name][1], "launches": launches[name],
            "parity": "allclose" if name == "ell_pagerank" else "bit-equal",
            "max_abs_err": parity[name], "ms": s["ms"],
            "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms_row_length"],
            "bound_by": s["bound_by"],
            "bound_bytes": s["bound_bytes_row_length"],
            "bound_ops": s["bound_ops"], "library_ms": s.get("library_ms"),
            "ms_without_deg": s["ms_without_deg"],
            "bound_ms_all_columns": s["bound_ms_all_columns"],
            "launch_floor_ms": floor_ms, "shapes": shapes[name],
            **variant_extra.get(name, {}),
            **(multi_detail if name == "ell_multi" else {})})
    emit(phase="combine_timing", order="plain,kernel,kernel,plain; "
         "without deg, with deg, with deg, without deg", N=N, Cd=Cd, K=None,
         valid_slots=n_valid, shapes=shapes,
         sparse_mm_ms=timed["ell_pagerank"]["library_ms"],
         sparse_mm_max_abs_err_vs_kernel=timed["ell_pagerank"][
             "library_max_abs_err_vs_kernel"])
    return out


def _frontier_adj_bytes(adj, f, need):
    """Adjacency bytes a dense hop must read for these masks: none for a
    row that needs no column; up to the column where its last needed
    frontier column is first hit, when every needed column is hit; the
    whole row otherwise."""
    import torch
    from repro_torch.kernels.frontier import frontier_step_plain

    N = adj.shape[0]
    ones = torch.ones(N, dtype=torch.bool, device=adj.device)
    hit = frontier_step_plain(adj, f, ones, ~need)  # (A @ F > 0) & need
    rows_need = need.any(dim=1)
    done = rows_need & (hit == need).all(dim=1)
    cols = int((rows_need & ~done).sum()) * N
    for u in done.nonzero()[:, 0].split(256):
        m = (adj[u] != 0)[:, :, None] & f[None, :, :]  # (rows, N, R)
        first = m.to(torch.int8).argmax(dim=1) + 1  # the first hit, per column
        cols += int(torch.where(need[u], first, 0).amax(dim=1).sum())
    return 2 * cols


def dense_timing(g, core, window, parity, launches):
    """The two dense kernels at the main path's shapes on DS1's dense
    adjacency, each beside its plain version, its bounds and a
    product-only yardstick: `torch.matmul` of the bf16 adjacency by the
    bf16 threshold matrix or frontier, which computes the product alone
    (no h-index, no mask; the port never calls it).

    `kcore_hindex` at the stream's clamped recompute (K = Cd + 1, est = the
    coreness; most launches) and at the static fixpoint (K = the degree
    bound, est = degrees).  Its bytes bound reads the adjacency once
    (N^2 * 2 bytes) with est and out; its operations bound is the product
    formulation's 2 N^2 K at the bf16 tensor-core rate.  `frontier` at the
    first hop of the stream's first window, with the per-column
    eligibility folded into `visited` as `ops.frontier_blocks` passes it,
    and with every row live (all eligible, none visited).  Its bound
    counts the adjacency these masks need (`_frontier_adj_bytes`) with f,
    eligible, visited and out, and the same with every row read."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.frontier import frontier_step, frontier_step_plain
    from repro_torch.kernels.kcore_hindex import (
        hindex_counts, hindex_counts_plain)

    N, Cd, dev = g.N, g.Cd, g.device
    adj = ref.ell_to_dense(g.nbr, N)
    adj_b = N * N * 2
    split = launches["kcore_hindex_split"]
    h_shapes = []
    for shape, est, K, n in (
            ("stream recompute: K=Cd+1, est=coreness", core, Cd + 1,
             split["stream"]),
            ("static fixpoint: K=degree_bound, est=degrees", g.deg,
             ops.degree_bound(g), split["static"])):
        ks = torch.arange(1, K + 1, dtype=torch.int32, device=dev)
        thr = (est[:, None] >= ks[None, :]).to(torch.bfloat16)
        ms, plain_ms = _time_pair(lambda: hindex_counts(adj, est, K),
                                  lambda: hindex_counts_plain(adj, est, K))
        nbytes, nops = adj_b + 2 * N * 4, 2 * N * N * K
        h_shapes.append(dict(
            shape=shape, K=K, launches=n, ms=ms, plain_ms=plain_ms,
            product_only_ms=_time_ms(lambda: torch.matmul(adj, thr)),
            bound_bytes=nbytes, bound_ms_bytes=_bound_ms(nbytes),
            bound_ops=nops, bound_ms_ops=nops / BF16_OPS_PER_S * 1e3))

    f, elig, _ = _first_hop(g, core, window)
    fb = f.to(torch.bfloat16)
    ones = torch.ones(N, dtype=torch.bool, device=dev)
    io = N * (3 * R + 1)  # f, eligible, visited read; out written
    f_shapes = []
    for shape, vis in (("main path: first hop, folded masks",
                        (f | ~elig).contiguous()),
                       ("every row live", torch.zeros_like(f))):
        adj_need = _frontier_adj_bytes(adj, f, ~vis)
        ms, plain_ms = _time_pair(
            lambda: frontier_step(adj, f, ones, vis),
            lambda: frontier_step_plain(adj, f, ones, vis))
        nbytes, nops = io + adj_need, adj_need * R  # 2R ops per element
        f_shapes.append(dict(
            shape=shape, R=R, rows_needing=int((~vis).any(dim=1).sum()),
            ms=ms, plain_ms=plain_ms,
            product_only_ms=_time_ms(lambda: torch.matmul(adj, fb)),
            bound_bytes=nbytes, bound_ms_bytes=_bound_ms(nbytes),
            bound_ops=nops, bound_ms_ops=nops / BF16_OPS_PER_S * 1e3,
            bound_bytes_every_row=io + adj_b,
            bound_ms_every_row=_bound_ms(io + adj_b)))
    emit(phase="dense_timing", order="plain,kernel,kernel,plain", N=N,
         adjacency_bytes=adj_b, hindex_shapes=h_shapes,
         frontier_shapes=f_shapes)
    del adj
    torch.cuda.empty_cache()

    def entry(name, s, **extra):
        bound_ms = max(s["bound_ms_bytes"], s["bound_ms_ops"])
        return {"name": name, "route": "cuda",
                "source": f"src/repro_torch/kernels/csrc/{name}.cu",
                "replaces": KERNELS[name][1], "launches": launches[name],
                "parity": "bit-equal", "max_abs_err": parity[name],
                "ms": s["ms"], "plain_ms": s["plain_ms"], "bound_ms": bound_ms,
                "bound_by": ("bytes" if s["bound_ms_bytes"] >= s["bound_ms_ops"]
                             else "operations"),
                "bound_bytes": s["bound_bytes"], "bound_ops": s["bound_ops"],
                "library_ms": None, "product_only_ms": s["product_only_ms"],
                **extra}

    return [entry("kcore_hindex", h_shapes[0], shapes=h_shapes),
            entry("frontier", f_shapes[0], shapes=f_shapes)]


if __name__ == "__main__":
    sys.exit(main())
