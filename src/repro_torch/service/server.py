"""The serving loop: admission -> kind buckets -> batches between windows.

`QueryServer` owns a `StreamSession` (writes) and an `AnalyticsState`
(reads) and time-slices the ONE device between them:

    submit(q)                # admission control: bounded queue or shed
    step(window)             # apply a stream window, refresh the epoch
                             # snapshot on cadence, answer all batches
    serve(updates, feed)     # the whole interleaved loop

Requests bucket by query kind (and by bucketed k for top-k), so every
batch is one gather of one kind; admission control is a single bounded
count across buckets with a reject-new shed policy — under overload the
queue cannot grow latency without bound, and sheds are counted per kind
in the metrics rather than silently dropped.

Nothing here is threaded: "concurrent" means interleaved on the device
timeline, the same way the paper's coordinator alternates worker compute
with masterCompute.  That is what makes answers exact — a batch runs
strictly between windows, against an immutable snapshot whose epoch is
recorded on every request it answers.
"""
from __future__ import annotations

import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Iterable, List, Optional, Tuple

from ..configs.service import ServiceConfig
from ..runtime.stream import StreamResult, StreamSession, _iter_windows
from . import queries as q
from .metrics import ServiceMetrics
from .state import AnalyticsState


@dataclass
class Request:
    """One admitted query: filled in place when its batch is answered."""

    query: q.Query
    t_submit: float
    done: bool = False
    answer: object = None
    epoch: int = -1          # snapshot epoch the answer was read from
    latency_s: float = field(default=float("nan"))


class QueryServer:
    """Bucket-batching query front end over one stream session.

    `session` must track CC labels (see `AnalyticsState`); `state` may
    be passed to share one across servers, else it is built from the
    config's `alpha`/`pr_steps`.  All knobs live on `ServiceConfig`.
    Everything runs on the session's graph's device.
    """

    def __init__(self, session: StreamSession,
                 state: Optional[AnalyticsState] = None,
                 config: Optional[ServiceConfig] = None):
        self.config = config if config is not None else ServiceConfig()
        self.session = session
        self.state = state if state is not None else AnalyticsState(
            session, alpha=self.config.alpha, pr_steps=self.config.pr_steps)
        self.metrics = ServiceMetrics()
        self._N = int(session.g.N)
        #: FIFO buckets: (kind[, bucketed k]) -> admitted requests
        self._buckets: "OrderedDict[Tuple, Deque[Request]]" = OrderedDict()
        self._depth = 0

    # -- admission ---------------------------------------------------------

    @property
    def queued(self) -> int:
        """Requests admitted but not yet answered."""
        return self._depth

    def _bucket_key(self, query: q.Query) -> Tuple:
        if query.kind == "topk_pagerank":
            return (query.kind, q.topk_bucket(query.k, self._N))
        return (query.kind,)

    def submit(self, query: q.Query) -> Optional[Request]:
        """Admit one query, or shed it (returns None) at the queue bound.

        Node arguments are validated against the padded id range here —
        a malformed id must fail the submitter, not poison a batch.
        """
        if query.kind not in q.KINDS:
            raise ValueError(
                f"unknown query kind {query.kind!r}; expected {q.KINDS}")
        if query.kind != "topk_pagerank":
            ids = ((query.u, query.v) if query.kind == "same_component"
                   else (query.u,))
            for i in ids:
                if not 0 <= i < self._N:
                    raise ValueError(
                        f"node id {i} outside the padded range "
                        f"[0, {self._N})")
        elif not 1 <= query.k <= self._N:
            raise ValueError(
                f"topk_pagerank k={query.k} outside [1, {self._N}]")
        if self._depth >= self.config.max_queue:
            self.metrics.observe_shed(query.kind)
            return None
        req = Request(query=query, t_submit=time.perf_counter())
        self._buckets.setdefault(self._bucket_key(query),
                                 deque()).append(req)
        self._depth += 1
        return req

    # -- answering ---------------------------------------------------------

    def _answer_batch(self, key: Tuple, batch: List[Request]) -> None:
        snap = self.state.snapshot
        kind = key[0]
        t0 = time.perf_counter()
        answers = q.run_batch(snap, kind, [r.query for r in batch],
                              k=key[1] if len(key) > 1 else 0)
        t1 = time.perf_counter()
        for req, ans in zip(batch, answers):
            req.answer = ans
            req.done = True
            req.epoch = snap.epoch
            req.latency_s = t1 - req.t_submit
        self.metrics.observe_batch(
            kind, [r.latency_s for r in batch],
            staleness=self.state.staleness(), busy_s=t1 - t0)

    def pump(self, max_batches: Optional[int] = None) -> int:
        """Answer queued batches (round-robin over buckets, FIFO within).

        Each turn drains at most `config.max_batch` requests from the
        oldest non-empty bucket; `max_batches` bounds the turns (None =
        drain everything).  Returns the number of queries answered.
        """
        answered = 0
        turns = 0
        while self._depth and (max_batches is None or turns < max_batches):
            key, dq = next(iter(self._buckets.items()))
            batch = [dq.popleft()
                     for _ in range(min(len(dq), self.config.max_batch))]
            self._depth -= len(batch)
            # rotate: re-queue a non-empty bucket at the back, so one hot
            # kind cannot starve the others
            del self._buckets[key]
            if dq:
                self._buckets[key] = dq
            self._answer_batch(key, batch)
            answered += len(batch)
            turns += 1
        return answered

    # -- the scheduling loop ----------------------------------------------

    def step(self, window: List[Tuple[int, int, int]]) -> int:
        """One serving turn: window -> cadenced refresh -> query batches.

        Returns the number of queries answered this turn.
        """
        self.session.apply_window(window)
        if self.session.windows_applied % self.config.refresh_every == 0:
            self.state.refresh()
        return self.pump()

    def serve(self, updates: Iterable[Tuple[int, int, int]],
              query_feed: Optional[Callable[[int], Iterable[q.Query]]]
              = None) -> StreamResult:
        """Drive the whole interleaved run over an update stream.

        Slices `updates` into the session's R-wide windows; before each
        window, submits `query_feed(window_index)`'s queries (sheds past
        the admission bound are recorded, not raised).  Drains any
        remaining queue after the last window, refreshing once more if
        the cadence left the final windows unsnapshotted, and returns
        the session's `StreamResult`.
        """
        for i, window in enumerate(_iter_windows(updates, self.session.R)):
            if query_feed is not None:
                for query in query_feed(i):
                    self.submit(query)
            self.step(window)
        if self.state.staleness() > 0:
            self.state.refresh()
        self.pump()
        return self.session.result()
