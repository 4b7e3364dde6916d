"""Fault detection & straggler mitigation — the run-controller side (the
JAX package's `distributed.fault`; no torch in it).

On real clusters, failure manifests as (a) a collective timeout, (b) a
missed heartbeat from a host, or (c) a SIGTERM from the platform.  This
module gives the training loop a small, testable state machine around
those events; tests simulate failures by raising `SimulatedFailure` from
a step callback.

Policy implemented:

  * heartbeat file per host, bumped every step; the controller marks a host
    dead after `timeout_steps` without progress;
  * on failure: abort the step, flush the last async checkpoint, exit with
    code 42 — the launcher interprets 42 as "restart me" and re-execs with
    ``--resume auto`` (possibly on a smaller mesh);
  * stragglers: per-step wall-time EWMA; a step slower than
    `straggler_factor` × EWMA raises a `StragglerWarning` so the controller
    can pre-emptively drain the slow host.
"""
from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path
from typing import Optional

RESTART_EXIT_CODE = 42


class SimulatedFailure(RuntimeError):
    """Raised by tests/chaos hooks to simulate a node loss mid-run."""


class StragglerWarning(RuntimeWarning):
    pass


@dataclasses.dataclass
class Heartbeat:
    path: str
    host: int = 0

    def beat(self, step: int):
        p = Path(self.path)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(json.dumps({"host": self.host, "step": step,
                                 "t": time.time()}))

    def last(self) -> Optional[dict]:
        p = Path(self.path)
        if not p.exists():
            return None
        return json.loads(p.read_text())


@dataclasses.dataclass
class StragglerMonitor:
    factor: float = 3.0
    alpha: float = 0.1
    _ewma: float = 0.0
    _n: int = 0

    def observe(self, step_seconds: float) -> bool:
        """Returns True if this step is a straggler outlier."""
        if self._n >= 5 and step_seconds > self.factor * self._ewma:
            return True
        self._ewma = (step_seconds if self._n == 0
                      else (1 - self.alpha) * self._ewma + self.alpha * step_seconds)
        self._n += 1
        return False
