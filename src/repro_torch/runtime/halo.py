"""Halo plan: the executed form of BLADYG's W2W exchange.

`GraphBlocks.nbr` stores *global* padded neighbor ids.  On the worker
mesh each worker holds only its own `S = B*Cn` node rows, so every valid
neighbor slot is either served locally (the neighbor lives on the same
worker) or from the *halo*: values fetched from the owning worker each
superstep.  This module precomputes, on the host from the adjacency,
everything that exchange needs:

  * per worker pair (r needs-from s): the sorted unique remote node ids,
    deduplicated — a node read by many local neighbor slots crosses the
    wire once per superstep, the paper's one-message-per-boundary-vertex
    W2W semantics;
  * `send_idx[s, r, k]` — local row on sender s of the k-th value it
    serves to receiver r (the all-to-all send-buffer gather);
  * `recv_pos[r, s, k]` — where receiver r scatters that value inside its
    halo buffer (size H; padded entries land on a dump slot, H);
  * `halo_ids[r]` — the halo-buffer layout itself: the sorted unique
    remote ids worker r reads, padded with -1 (position k in this row IS
    halo position k);
  * `nbr_local` — the adjacency in each worker's local frame: own
    neighbors index the local shard `[0, S)`, remote neighbors index
    `S + halo position`, PAD slots index a sentinel (`pad_slot`) that
    always reads the ignore value.

Message accounting lives here too, at two granularities:

  * `slot_counts()` — (intra, inter) valid neighbor slots at *block*
    granularity (the paper's messaging unit; equal to
    `core.graph.halo_slot_counts`);
  * `device_elems` / `pair_elems` — unique values the all-to-all moves
    per superstep (worker granularity, deduplicated), and the (W, W)
    per-pair breakdown.

Shapes are static: `K` is the pair-payload capacity, `H` the halo
capacity, both rounded up to powers of two (with `H_min`/`K_min`
floors), so small halo growth under streaming updates keeps the buffers'
shapes, and when growth overflows a capacity the doubling lands
incremental and from-scratch plans on the same value.

The plan is a pure function of `nbr` **contents**, the same arrays as the
JAX package's plan for the same graph and mesh geometry.  After
structural updates either rebuild it (`build_halo_plan`) or, the
streaming hot path, maintain it with `HaloPlan.apply_updates`: an edge
touches at most two blocks, so only the workers owning its endpoints get
their halo tables re-derived, and only their rows (or, for worker-local
edits, only the touched rows) are read from the device.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

from .mesh import WorkerMesh, make_worker_mesh


def _pow2_ceil(x: int) -> int:
    """Smallest power of two >= max(1, x) — the capacity slack policy."""
    x = max(1, int(x))
    return 1 << (x - 1).bit_length()


def _host_rows(nbr: torch.Tensor, rows) -> np.ndarray:
    """Rows of `nbr` (a slice, or an array of row ids) as host numpy: one
    device-to-host copy of just those rows."""
    if not isinstance(rows, slice):
        rows = torch.as_tensor(rows, dtype=torch.long, device=nbr.device)
    return nbr[rows].cpu().numpy()


def _worker_uniq(nb: np.ndarray, r: int, S: int) -> np.ndarray:
    """Sorted unique remote ids referenced by worker r's rows `nb`."""
    v = nb >= 0
    remote = nb[v & (np.where(v, nb // S, -1) != r)]
    return np.unique(remote)


def _fill_receiver(
    send_idx: np.ndarray, recv_pos: np.ndarray, uniq_r: np.ndarray,
    r: int, S: int, W: int, H: int,
) -> None:
    """(Re)derive the send/recv tables of receiver column r from uniq_r.

    Sorting by global id groups by owner automatically (owner = id // S
    is monotone in id), so "position in the sorted unique array" doubles
    as the halo-buffer layout.
    """
    send_idx[:, r, :] = 0
    recv_pos[r, :, :] = H  # default: dump slot
    for s in range(W):
        ids = uniq_r[uniq_r // S == s]
        if not len(ids):
            continue
        pos = np.searchsorted(uniq_r, ids).astype(np.int32)
        send_idx[s, r, :len(ids)] = (ids - s * S).astype(np.int32)
        recv_pos[r, s, :len(ids)] = pos


def _local_rows(
    nbr_rows: np.ndarray, uniq_r: np.ndarray, r: int, S: int, H: int
) -> np.ndarray:
    """Remap global-id adjacency rows of worker r to its local frame:
    [0, S) own rows, [S, S+H) halo positions, S+H+1 the PAD sentinel."""
    out = np.full(nbr_rows.shape, S + H + 1, np.int32)
    v = nbr_rows >= 0
    ownm = v & (np.where(v, nbr_rows // S, -1) == r)
    rem = v & ~ownm
    out[ownm] = (nbr_rows[ownm] - r * S).astype(np.int32)
    out[rem] = (S + np.searchsorted(uniq_r, nbr_rows[rem])).astype(np.int32)
    return out


@dataclasses.dataclass(frozen=True)
class HaloPlan:
    """Precomputed W2W exchange for one (graph, worker mesh) pair."""

    wm: WorkerMesh
    K: int                 # pair-payload capacity (pow2-padded max)
    H: int                 # halo-buffer capacity (pow2-padded max)
    send_idx: np.ndarray   # (W, W, K) int32 — [sender, receiver, k] row
    recv_pos: np.ndarray   # (W, W, K) int32 — [receiver, sender, k] halo pos
    halo_len: np.ndarray   # (W,) int64 — real halo entries per worker
    halo_ids: np.ndarray   # (W, H) int64 — sorted unique remote ids, -1 pad
    nbr_local: np.ndarray  # (N, Cd) int32 — local-frame adjacency
    pair_elems: np.ndarray  # (W, W) int64 — unique values moved s -> r
    slot_intra: int        # valid slots inside their own *block*
    slot_inter: int        # valid slots crossing a *block* boundary

    def slot_counts(self) -> Tuple[int, int]:
        """(intra, inter) at block granularity == `graph.halo_slot_counts`."""
        return self.slot_intra, self.slot_inter

    @property
    def device_elems(self) -> int:
        """Unique values crossing a *worker* boundary per superstep."""
        off = ~np.eye(self.wm.W, dtype=bool)
        return int(self.pair_elems[off].sum())

    @property
    def padded_elems(self) -> int:
        """Physical all-to-all payload per superstep (static padding)."""
        return self.wm.W * self.wm.W * self.K

    #: index (into the concat [local values | halo buffer]) that always
    #: holds the ignore value — PAD neighbor slots point here.
    @property
    def pad_slot(self) -> int:
        return self.wm.S + self.H + 1

    # -----------------------------------------------------------------
    # incremental maintenance (the streaming hot path)
    # -----------------------------------------------------------------

    def apply_updates(self, g, edits: Sequence[Tuple[int, int, int]]
                      ) -> "HaloPlan":
        """Incrementally maintain the plan after edge `edits`.

        `g` is the POST-update graph (its `nbr` already reflects the
        edits); `edits` is a sequence of (u, v, op) with op = +1 insert /
        -1 delete (op == 0 padding entries are skipped).  An edge touches
        at most two blocks, hence at most two workers: only those dirty
        workers get their halo layout (`halo_ids`, send/recv column,
        local-frame rows) re-derived, from their own rows of `nbr`, plus
        the touched rows of worker-local edits.

        Capacity growth follows the doubling policy: H/K only ever grow,
        to the next power of two that fits, so the result is
        field-for-field identical to
        `build_halo_plan(g, wm, H_min=self.H, K_min=self.K)`.

        Returns the maintained `HaloPlan` (a new frozen instance; `self`
        unchanged — and returned as-is when every edit is an op == 0
        no-op).
        """
        wm = self.wm
        S, W, Cn = wm.S, wm.W, g.Cn
        edits = [(int(u), int(v), int(op)) for u, v, op in edits
                 if int(op) != 0]
        if not edits:
            return self

        # slot counts move by +-2 per edit (one slot per endpoint row)
        slot_intra, slot_inter = self.slot_intra, self.slot_inter
        dirty: set = set()
        touched: set = set()
        for u, v, op in edits:
            d = 2 if op > 0 else -2
            if u // Cn == v // Cn:
                slot_intra += d
            else:
                slot_inter += d
            touched.add(u)
            touched.add(v)
            if u // S != v // S:  # remote reference created/removed
                dirty.add(u // S)
                dirty.add(v // S)

        halo_len = self.halo_len.copy()
        pair_elems = self.pair_elems.copy()
        shard = {r: _host_rows(g.nbr, slice(r * S, (r + 1) * S))
                 for r in sorted(dirty)}
        uniq_new = {r: _worker_uniq(shard[r], r, S) for r in shard}
        for r, u_ in uniq_new.items():
            halo_len[r] = len(u_)
            pair_elems[:, r] = (np.bincount(u_ // S, minlength=W)
                                if len(u_) else 0)

        H = max(self.H, _pow2_ceil(int(halo_len.max()) if W else 1))
        K = max(self.K, _pow2_ceil(int(pair_elems.max())))

        # grow tables (stale capacity-dependent sentinels are remapped:
        # the dump slot H and the PAD sentinel S+H+1 move with H)
        if K != self.K:
            send_idx = np.zeros((W, W, K), np.int32)
            send_idx[:, :, :self.K] = self.send_idx
            recv_pos = np.full((W, W, K), self.H, np.int32)
            recv_pos[:, :, :self.K] = self.recv_pos
        else:
            send_idx = self.send_idx.copy()
            recv_pos = self.recv_pos.copy()
        if H != self.H:
            recv_pos = np.where(recv_pos == self.H, H, recv_pos
                                ).astype(np.int32)
            nbr_local = np.where(self.nbr_local == S + self.H + 1,
                                 S + H + 1, self.nbr_local).astype(np.int32)
            halo_ids = np.full((W, H), -1, np.int64)
            halo_ids[:, :self.H] = self.halo_ids
        else:
            nbr_local = self.nbr_local.copy()
            halo_ids = self.halo_ids.copy()

        for r, u_ in uniq_new.items():
            _fill_receiver(send_idx, recv_pos, u_, r, S, W, H)
            halo_ids[r, :] = -1
            halo_ids[r, :len(u_)] = u_
            nbr_local[r * S:(r + 1) * S] = _local_rows(shard[r], u_, r, S, H)

        # rows touched by worker-local edits: the halo layout of their
        # worker is unchanged (the stored halo_ids row is its layout),
        # only the row contents moved (insert appends, delete swaps)
        local = [u for u in sorted(touched) if u // S not in uniq_new]
        if local:
            rows = _host_rows(g.nbr, np.asarray(local, np.int64))
            for u, row in zip(local, rows):
                r = u // S
                u_ = halo_ids[r, :halo_len[r]]
                nbr_local[u] = _local_rows(row[None], u_, r, S, H)[0]

        return HaloPlan(
            wm=wm, K=K, H=H, send_idx=send_idx, recv_pos=recv_pos,
            halo_len=halo_len, halo_ids=halo_ids, nbr_local=nbr_local,
            pair_elems=pair_elems,
            slot_intra=slot_intra, slot_inter=slot_inter,
        )


def build_halo_plan(
    g, wm: WorkerMesh = None, W: int = None,
    H_min: int = 1, K_min: int = 1,
) -> HaloPlan:
    """Derive the halo plan from `GraphBlocks.nbr` (one copy to the host).

    `wm` defaults to `make_worker_mesh(g, W=W)`.  `H_min`/`K_min` floor
    the capacities (a plan maintained through `apply_updates` never
    shrinks its buffers); both are then padded up to powers of two by the
    slack policy.  Every rank of a mesh builds the same plan.
    """
    if wm is None:
        wm = make_worker_mesh(g, W=W)
    nbr = _host_rows(g.nbr, slice(None))
    N, Cd = nbr.shape
    S, Wn = wm.S, wm.W
    assert N == wm.N, (N, wm.N)

    valid = nbr >= 0
    own_block = np.arange(N) // g.Cn
    inter_blk = valid & (np.where(valid, nbr // g.Cn, -1)
                         != own_block[:, None])
    slot_inter = int(inter_blk.sum())
    slot_intra = int(valid.sum()) - slot_inter

    uniq = [_worker_uniq(nbr[r * S:(r + 1) * S], r, S) for r in range(Wn)]
    halo_len = np.array([len(u) for u in uniq], np.int64)
    H = max(int(H_min), _pow2_ceil(int(halo_len.max()) if Wn else 1))
    pair_elems = np.zeros((Wn, Wn), np.int64)
    for r in range(Wn):
        owners = uniq[r] // S
        cnt = np.bincount(owners, minlength=Wn) if len(owners) else \
            np.zeros(Wn, np.int64)
        pair_elems[:, r] = cnt  # column r: what each sender moves to r
    K = max(int(K_min), _pow2_ceil(int(pair_elems.max())))

    send_idx = np.zeros((Wn, Wn, K), np.int32)
    recv_pos = np.full((Wn, Wn, K), H, np.int32)  # default: dump slot
    halo_ids = np.full((Wn, H), -1, np.int64)
    nbr_local = np.full((N, Cd), S + H + 1, np.int32)
    for r in range(Wn):
        _fill_receiver(send_idx, recv_pos, uniq[r], r, S, Wn, H)
        halo_ids[r, :len(uniq[r])] = uniq[r]
        rows = slice(r * S, (r + 1) * S)
        nbr_local[rows] = _local_rows(nbr[rows], uniq[r], r, S, H)

    return HaloPlan(
        wm=wm, K=K, H=H, send_idx=send_idx, recv_pos=recv_pos,
        halo_len=halo_len, halo_ids=halo_ids, nbr_local=nbr_local,
        pair_elems=pair_elems,
        slot_intra=slot_intra, slot_inter=slot_inter,
    )


def mirror_merge_payload(plan, n_fields: int = 1) -> int:
    """Per-superstep collective payload of the hub-mirror merge on a worker
    mesh, in elements.

    A mirrored run (see `core.hub_split`) adds one combine-then-broadcast
    collective per merged field per superstep: each worker folds its
    resident replica-group rows into a dense (Gmax + 1,) per-group
    partial table and the tables merge with one min/sum reduction over
    the workers.  That table IS the wire payload, independent of how many
    replica rows exist or where they live: the merge cost is bounded by
    the number of split hubs, not by hub degree.

    Returns elements per superstep for `n_fields` min/sum fields; an
    h-index field costs `(Gmax + 1) * Km` instead, which callers account
    for by passing the histogram width as extra fields.  Counter only —
    no device code.
    """
    return (int(plan.Gmax) + 1) * int(n_fields)
