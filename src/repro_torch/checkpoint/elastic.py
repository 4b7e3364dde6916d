"""Resume a graph stream from a snapshot: `save_session`,
`restore_session`.

A snapshot holds everything `StreamSession.state_dict` or
`MirrorStream.state_dict` emits — the graph blocks (and the hub-split
plan), the maintained coreness and CC labels, the open-time id map and
every counter — plus the capacities (P, Cn, Cd) in the manifest meta, so
a restore works after capacity escalations the restoring process never
saw.  The layout is the JAX package's: a snapshot of either kind written
by the JAX package restores here (its backend overridden to one of this
package's), and this package's flat dicts restore there.

Not ported yet: restoring onto a worker mesh (`W > 1`, `executor=`,
`backend="ell_spmd"` raise NotImplementedError; ROADMAP.md Queue 1 item
6, step 4).
"""
from __future__ import annotations

from typing import Optional, Tuple

from ..device import DeviceLike
from ..kernels.ops import refuse_spmd, spmd_not_ported
from ..runtime.stream import MirrorStream, StreamSession
from .manager import CheckpointManager


def save_session(mgr: CheckpointManager, session, step: Optional[int] = None,
                 blocking: bool = True, extra_meta: Optional[dict] = None
                 ) -> int:
    """Snapshot a `StreamSession` or `MirrorStream` at `step` (default: its
    `windows_applied` clock).  `extra_meta` (JSON-able) rides along under
    meta["extra"].  The session's tensors are on the host before this
    returns, also with `blocking=False`.  Returns the step saved."""
    arrays, meta = session.state_dict()
    if extra_meta is not None:
        meta = {**meta, "extra": extra_meta}
    if step is None:
        step = int(session.windows_applied)
    mgr.save(step, arrays, blocking=blocking, meta=meta)
    return step


def restore_session(mgr: CheckpointManager, step: Optional[int] = None,
                    W=None, backend: Optional[str] = None, executor=None,
                    device: DeviceLike = None) -> Tuple[int, object, dict]:
    """Rebuild a stream session from the latest (or given) committed
    snapshot, on `device` (default CUDA, see `device.resolve_device`).

    A ``stream_session`` snapshot comes back as a `StreamSession`, a
    ``mirror_stream`` one as a `MirrorStream`.  `backend` overrides the
    snapshot's.  `W > 1`, `executor` and the `ell_spmd` backend need the
    mesh runtime and raise NotImplementedError.  Returns ``(step,
    session, meta)``; meta is the manifest meta.
    """
    if step is None:
        step = mgr.latest_step()
        if step is None:
            raise FileNotFoundError(
                f"no committed checkpoint to restore in {mgr.dir}")
    meta = mgr.load_meta(step)
    if not meta or "kind" not in meta:
        raise ValueError(
            f"step {step} carries no session meta; was it saved with "
            "save_session?")
    kinds = {"stream_session": StreamSession, "mirror_stream": MirrorStream}
    if meta["kind"] not in kinds:
        raise ValueError(f"unknown snapshot kind {meta['kind']!r}")
    be = meta["backend"] if backend is None else backend
    refuse_spmd(be, "restore_session", 4)
    if (W is not None and int(W) > 1) or executor is not None:
        spmd_not_ported("restore_session onto a worker mesh (W > 1, "
                        "executor=)", 4)
    arrays = mgr.restore_dict(step, device=device)
    session = kinds[meta["kind"]].from_state(arrays, meta, backend=be,
                                             device=device)
    return step, session, meta


#: the JAX package's name for a restore onto another worker count; with
#: one device it is `restore_session`
remesh_restore = restore_session
