"""Deterministic, seekable, host-sharded data pipelines (the JAX package's
`data.pipeline`, in its own numpy copy: the batches are numpy arrays, as
the reference's are, and equal them).

Two sources:

  * `SyntheticTokens`  — deterministic PRNG tokens keyed by (seed, step,
    host); zero I/O, arbitrary scale.  Mimics a Zipfian unigram
    distribution so losses are non-trivial.
  * `ByteCorpus`       — byte-level tokens from a local file (quickstart).

Both are *cursor-addressed*: `batch(step)` is a pure function of the step
index, so checkpoint-restart (and elastic restarts with a different host
count) replays exactly-once without coordination.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict

import numpy as np


@dataclasses.dataclass(frozen=True)
class SyntheticTokens:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    host_index: int = 0
    host_count: int = 1
    zipf_a: float = 1.2

    @property
    def local_batch(self) -> int:
        assert self.global_batch % self.host_count == 0
        return self.global_batch // self.host_count

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.host_index]))
        z = rng.zipf(self.zipf_a, size=(self.local_batch, self.seq_len + 1))
        toks = (z - 1) % self.vocab
        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }


@dataclasses.dataclass
class ByteCorpus:
    """Random windows of a byte file.  The windows are keyed by
    ``hash(self.path)``, as the reference's: Python randomizes string
    hashes per process (`PYTHONHASHSEED`), so two processes draw other
    windows for the same step, and this pipeline equals the reference's
    only within one process."""
    path: str
    seq_len: int
    global_batch: int
    host_index: int = 0
    host_count: int = 1
    vocab: int = 256

    def __post_init__(self):
        self._data = np.frombuffer(Path(self.path).read_bytes(), dtype=np.uint8)
        assert len(self._data) > self.seq_len + 1, "corpus too small"

    @property
    def local_batch(self) -> int:
        return self.global_batch // self.host_count

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        n = len(self._data) - self.seq_len - 1
        rng = np.random.default_rng(
            np.random.SeedSequence([hash(self.path) & 0x7FFFFFFF,
                                    step, self.host_index]))
        starts = rng.integers(0, n, size=self.local_batch)
        rows = np.stack([self._data[s : s + self.seq_len + 1] for s in starts])
        return {
            "tokens": rows[:, :-1].astype(np.int32),
            "labels": rows[:, 1:].astype(np.int32),
        }
