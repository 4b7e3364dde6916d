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

`save_train_state` writes a model's parameters and optimizer state as
sibling sub-checkpoints (``params/`` and ``opt/``), in the JAX package's
layout, so either package restores the other's train state with
`CheckpointManager.restore` and a template.

Snapshots are topology-independent (global arrays), so a stream session
restores onto any worker mesh with W | P: `restore_session(W=,
backend="ell_spmd", executor=)` is also the remesh path
(`remesh_restore`).  Every rank of the mesh restores the same snapshot
and stages its shard.
"""
from __future__ import annotations

from typing import Optional, Tuple

from ..device import DeviceLike
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
    snapshot's; a stream session takes `W`/`executor` too (the mesh to
    restore onto, W | P; see the module docstring), which a mirrored
    session does not read, as in the JAX package.  Returns ``(step,
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
    mesh = dict(W=W, executor=executor) if kinds[meta["kind"]] \
        is StreamSession else {}
    arrays = mgr.restore_dict(step, device=device)
    session = kinds[meta["kind"]].from_state(arrays, meta, backend=be,
                                             device=device, **mesh)
    return step, session, meta


#: restore_session IS the remesh path: the alias names the intent at call
#: sites that restore onto another worker count after a loss
remesh_restore = restore_session


def save_train_state(mgr: Optional[CheckpointManager], step: int, params,
                     opt_state, blocking: bool = True):
    """Save params and optimizer state (an `optim.AdamWState`) as sibling
    sub-checkpoints ``<dir>/params`` and ``<dir>/opt`` at `step`.

    DTensor leaves are written whole: every rank must call this (each
    takes part in `distributed.sharding.gather`), and only the ranks
    given a manager write (the launcher gives rank 0 one, the others
    None)."""
    from ..distributed.sharding import gather

    params, opt_state = gather(params), gather(opt_state)
    if mgr is None:
        return
    CheckpointManager(str(mgr.dir / "params"), mgr.keep_n).save(
        step, params, blocking=blocking)
    CheckpointManager(str(mgr.dir / "opt"), mgr.keep_n).save(
        step, opt_state, blocking=blocking)
