"""Checkpointing for the graph stream: atomic keep-N snapshots of
`GraphBlocks`, analytics and stream-session state, in the JAX package's
on-disk layout."""
from .manager import CheckpointManager
from .elastic import remesh_restore, restore_session, save_session

__all__ = ["CheckpointManager", "remesh_restore", "restore_session",
           "save_session"]
