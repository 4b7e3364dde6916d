"""Checkpointing for the graph stream and the training state: atomic
keep-N snapshots of `GraphBlocks`, analytics and stream-session state,
and a model's parameters and optimizer state, in the JAX package's
on-disk layout."""
from .manager import CheckpointManager
from .elastic import (remesh_restore, restore_session, save_session,
                      save_train_state)

__all__ = ["CheckpointManager", "remesh_restore", "restore_session",
           "save_session", "save_train_state"]
