"""The h-index merge of a hub-split graph: CUDA kernel and plain version.

Under a mirrored run (`core.hub_split`, `ops.run_block_program(mirror=)`)
an "hindex" combine gives each row the h-index of its own slice only, and
partial h-indexes do not compose: each replica group's h-index has to be
taken over the values of its whole logical neighbourhood, and written to
every row of the group,

    h[g] = max{t in [0, top] : #{v in V_g : v >= t} >= t},
    V_g  = {field[nbr[r, j]] : r a row of g, nbr[r, j] >= 0},

with `top` the group's logical degree (`mirror.ldeg`), which its slots
number, so h never exceeds it.  Every other row passes through.

`hindex_mirror` launches `csrc/mirror_hindex.cu` on CUDA tensors (and
bumps `hindex_mirror.launches`) and runs `hindex_mirror_plain` on CPU
tensors; any other device raises.  Both read the plan's groups through
one index, `group_layout`, made once a run on the plan's device with no
host read: each group's start in `grp_rows` (the plan lists its entries
group by group, `grp_gid` non-decreasing with the padding last), its
logical degree `top`, and the order the kernel takes the groups in.  The
min and sum merges (`ops._mirror_merge`) read the same index.  The kernel
counts each group in shared memory and adds to
`hindex_mirror.wide_groups`, a count kept on the card, for every group
whose h climbs past its first window of thresholds (read with ``int()``).
Since the merge re-reads every group row whole, `skip_group_rows` gives
the ELL h-index combine before it those rows at length 0.

The plain version counts every group's values into the group's own
segment of ``top + 1`` bins of one flat histogram (value v in bin
min(max(v, 0), top)), integer scatter-adds in any order, then reads each
h from the segments' prefix sums by halving [0, top].  The histogram's
length comes from shapes alone, and it takes an `all_reduce` that sums
the bins across a mesh's workers (`runtime.spmd`), which the kernel does
not take.  The JAX package's merge compares every value with every
threshold in an (Rp, Cd, Km) cube, in jnp outside its kernels: no TPU
kernel stands behind this one.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from . import _build
from .ell_hindex import check_deg, check_field, on_cuda

#: the largest logical degree a group may have and still be given one
#: warp: `csrc/mirror_hindex.cu`'s warp window, 1 + kReg + kWarpBins
#: thresholds (1 + 4 + 512), then spans the whole of [1, top]
WARP_TOP = 517


@dataclasses.dataclass
class GroupLayout:
    """A plan's replica groups as every merge reads them (`group_layout`).

    offsets: (Gmax + 1,) int64 — group g's entries are
             ``grp_rows[offsets[g]:offsets[g + 1]]`` (empty for a pad
             group).
    top:     (Gmax,) int64 — each group's logical degree (0 on a pad
             group).
    order:   (Gmax,) int64 — the groups by logical degree, largest first
             (ties in group order): the order the kernel takes them in.
    nbig:    () int64 — how many groups have a logical degree above
             `WARP_TOP`: the first `nbig` of `order`, one CTA each.
    """

    offsets: torch.Tensor
    top: torch.Tensor
    order: torch.Tensor
    nbig: torch.Tensor


def group_layout(mirror) -> GroupLayout:
    """`GroupLayout` of a `core.hub_split.MirrorPlan`, on its device, with
    no host read: searches over its non-decreasing `grp_gid`."""
    gid = mirror.grp_gid
    offsets = torch.searchsorted(gid, torch.arange(
        mirror.Gmax + 1, dtype=gid.dtype, device=gid.device))
    start = offsets[:-1]
    first = mirror.grp_rows[start.clamp(max=gid.numel() - 1)].long()
    top = torch.where(offsets[1:] > start, mirror.ldeg[first], 0).long()
    order = torch.sort(top, descending=True, stable=True).indices
    return GroupLayout(offsets=offsets, top=top, order=order,
                       nbig=(top > WARP_TOP).sum())


def group_entries(mirror, N: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(row, group) of each of the plan's (Rp,) group entries, int64.  A
    pad entry's row is N, one past the rows, where a merge reads its fill;
    its group is its position modulo Gmax, so that the pad entries spread
    over the groups and no one slot takes them all.  There they add only
    the fill, 0 or a count in bin 0, which change no group's value."""
    gid = mirror.grp_gid.long()
    live = gid < mirror.Gmax
    spread = torch.arange(gid.numel(), device=gid.device) % mirror.Gmax
    return (torch.where(live, mirror.grp_rows.long(), N),
            torch.where(live, gid, spread))


def put_groups(red: torch.Tensor, mirror, out: torch.Tensor) -> torch.Tensor:
    """`red` with each group row set to its group's value in `out`, (Gmax,),
    by the plan's `row_gid`; a new tensor."""
    g = mirror.row_gid
    out = torch.cat([out.to(red.dtype), red.new_zeros(1)])  # Gmax: no group
    return torch.where(g < mirror.Gmax, out[g], red)


def skip_group_rows(deg: torch.Tensor, mirror) -> torch.Tensor:
    """The row lengths an ELL h-index combine takes under a mirrored run:
    `deg`, the split graph's, with 0 on every live group row (``row_gid <
    Gmax``); a new tensor, made on the plan's device with no host read.

    The merge writes each of those rows from its group's whole
    neighbourhood, reading them up to the real `deg`, so the combine's
    partial there is never read; a row of length 0 costs the kernel one
    read of its length and one write.  Bumps `skip_group_rows.runs` and
    adds the rows skipped to `skip_group_rows.rows`, a count on the card.
    """
    live = mirror.row_gid < mirror.Gmax
    skip_group_rows.rows.at(deg.device).add_(live.sum())
    skip_group_rows.runs += 1
    return torch.where(live, 0, deg)


class DeviceCount:
    """A count a kernel adds to on the card: one int64 a device, made at
    the first launch there.  ``int(count)`` reads them all (a host read,
    made only by whoever asks)."""

    def __init__(self):
        self._at: Dict[torch.device, torch.Tensor] = {}

    def at(self, device: torch.device) -> torch.Tensor:
        if device not in self._at:
            self._at[device] = torch.zeros(1, dtype=torch.int64,
                                           device=device)
        return self._at[device]

    def __int__(self) -> int:
        return sum(int(t) for t in self._at.values())


def _segment_hindex(hist: torch.Tensor, base: torch.Tensor,
                    top: torch.Tensor, steps: int) -> torch.Tensor:
    """h per group from its count segment ``hist[base : base + top + 1]``
    (bin b holds the values min(v, top) == b): the largest t in [0, top]
    with #{v >= t} >= t, by `steps` halvings of [0, top] (cnt_t falls as
    t rises, so the t that pass form a prefix)."""
    cum = hist.cumsum(0)
    total = cum[base + top]
    lo, hi = torch.zeros_like(top), top.clone()
    for _ in range(steps):
        open_ = lo < hi
        mid = (lo + hi + 1) // 2
        # #{v >= mid} = total - #{v <= mid - 1}
        ok = open_ & (total - cum[(base + mid - 1).clamp(min=0)] >= mid)
        lo, hi = (torch.where(ok, mid, lo),
                  torch.where(open_ & ~ok, mid - 1, hi))
    return lo


def hindex_mirror_plain(red: torch.Tensor, field: torch.Tensor,
                        nbr: torch.Tensor, mirror, layout: GroupLayout,
                        all_reduce: Optional[Callable] = None
                        ) -> torch.Tensor:
    """The plain version: `red` with each live group row replaced by its
    group's h-index; a new tensor.  Re-reads each group row's neighbor
    values ``field[nbr[rows]]``, counts them in the group's own segment of
    ``top + 1`` bins (`layout.top`) and halves [0, top]
    ``Km.bit_length() + 1`` times.  Empty slots, pad entries and entries
    whose row is off the frame (`group_entries`) count in a bin 0, which no
    h reads.  ``all_reduce(hist, "sum")``, where given, sums the
    bins across a mesh's workers before h is read."""
    N, G, Cd = red.shape[0], mirror.Gmax, nbr.shape[1]
    rows, gid = group_entries(mirror, N)
    nb = nbr.index_select(0, rows.clamp(max=N - 1))
    vals = field.index_select(0, nb.clamp(min=0).reshape(-1)).view(nb.shape)
    vals = torch.where((nb >= 0) & (rows < N)[:, None], vals, 0).clamp_(min=0)
    del nb
    top = layout.top
    width = top + 1
    base = width.cumsum(0) - width
    vals = torch.minimum(vals, top[gid][:, None].to(vals.dtype))
    bins = (base[gid][:, None] + vals).reshape(-1)
    del vals
    # sum(top + 1) <= Rp * Cd + Gmax, as a group's slots number its
    # degree: a length from shapes alone, the same on every mesh worker
    hist = torch.zeros(rows.numel() * Cd + G, dtype=torch.int32,
                       device=red.device).scatter_add_(
        0, bins, torch.ones((), dtype=torch.int32,
                            device=red.device).expand(bins.shape))
    del bins
    if all_reduce is not None:
        hist = all_reduce(hist, "sum")
    return put_groups(red, mirror, _segment_hindex(
        hist, base, top, int(mirror.Km).bit_length() + 1))


def hindex_mirror(red: torch.Tensor, field: torch.Tensor, nbr: torch.Tensor,
                  deg: Optional[torch.Tensor], mirror,
                  layout: Optional[GroupLayout] = None) -> torch.Tensor:
    """`red` with every row of every replica group of `mirror` replaced by
    the group's h-index over `field`; a new tensor.

    `layout` is the plan's `group_layout` (made here when None).  CUDA
    tensors launch `csrc/mirror_hindex.cu`: `red` and `field` int32
    (`field` may have more rows than `nbr`), `deg` the split graph's row
    lengths (`g.deg`, required).  CPU tensors take `hindex_mirror_plain`.
    Both give the same integers.
    """
    cuda = on_cuda(nbr, "hindex_mirror")
    if layout is None:
        layout = group_layout(mirror)
    if not cuda:
        return hindex_mirror_plain(red, field, nbr, mirror, layout)
    check_field(nbr, field, longer=True, name="field")
    check_field(nbr, red, name="red")
    if deg is None:
        raise ValueError("hindex_mirror on CUDA reads each row up to its "
                         "length: pass deg")
    check_deg(nbr, deg)
    for name in ("ldeg", "grp_rows"):
        t = getattr(mirror, name)
        if t.dtype != torch.int32 or t.device != nbr.device:
            raise ValueError(f"mirror.{name} must be int32 on {nbr.device}")
    out = red.clone()
    _build.launch("mirror_hindex", nbr.device, nbr.data_ptr(),
                  deg.data_ptr(), field.data_ptr(), mirror.ldeg.data_ptr(),
                  mirror.grp_rows.data_ptr(), layout.offsets.data_ptr(),
                  layout.order.data_ptr(), layout.nbig.data_ptr(),
                  out.data_ptr(),
                  hindex_mirror.wide_groups.at(nbr.device).data_ptr(),
                  mirror.Gmax, nbr.shape[1])
    hindex_mirror.launches += 1
    return out


#: kernel launches so far (the CPU path does not count)
hindex_mirror.launches = 0
#: groups whose h climbed past the kernel's first window, on the card
hindex_mirror.wide_groups = DeviceCount()
#: runs whose combine skipped the live group rows, and the rows skipped
#: (a count on the card, read with ``int()``)
skip_group_rows.runs = 0
skip_group_rows.rows = DeviceCount()
