"""Single-device stream runtime of the port (`stream`)."""
from .stream import (
    StreamResult, StreamSession, StreamStats, owner_block, route_updates,
    run_stream,
)

__all__ = ["StreamResult", "StreamSession", "StreamStats", "owner_block",
           "route_updates", "run_stream"]
