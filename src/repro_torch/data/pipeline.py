"""Deterministic, sharded, checkpointable data pipeline.

Sources:
  * SyntheticLM — seeded Zipf-ish token stream generated on the fly
    (deterministic per (seed, step, host)), for benchmarks and dry-runs;
  * MmapTokens — a flat binary token file (uint16/uint32) memory-mapped
    and cut into (tokens, targets) windows.

Properties required at cluster scale:
  * host sharding: each host yields only its slice of the global batch
    (host_id / host_count), and the trainer forms the global batch from
    the hosts' slices;
  * deterministic + checkpointable: the iterator's full state is one
    integer step — restoring it replays the exact same stream (recovery
    reproducibility after failures);
  * prefetch: a background thread keeps ``prefetch`` batches ready.

The port's copy of ``repro/data/pipeline.py``: the same numpy code, so
both packages yield the same token stream bit for bit.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator

import numpy as np


@dataclass
class SyntheticLM:
    vocab_size: int
    seed: int = 0

    def batch(self, step: int, rows: int, seq_len: int) -> np.ndarray:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step]))
        # Zipf-ish marginal over the vocab (more realistic router/embedding
        # traffic than uniform)
        ranks = rng.zipf(1.3, size=(rows, seq_len + 1)).astype(np.int64)
        return (ranks % self.vocab_size).astype(np.int32)


class MmapTokens:
    def __init__(self, path: str, vocab_size: int, dtype=np.uint16):
        self.tokens = np.memmap(path, dtype=dtype, mode="r")
        self.vocab_size = vocab_size

    def batch(self, step: int, rows: int, seq_len: int) -> np.ndarray:
        window = seq_len + 1
        n_windows = len(self.tokens) // window
        rng = np.random.default_rng(np.random.SeedSequence([17, step]))
        idx = rng.integers(0, n_windows, size=rows)
        out = np.stack([
            np.asarray(self.tokens[i * window:(i + 1) * window])
            for i in idx]).astype(np.int32)
        return out % self.vocab_size


class DataLoader:
    """Host-sharded, prefetching, checkpointable loader."""

    def __init__(self, source, global_batch: int, seq_len: int,
                 host_id: int = 0, host_count: int = 1, prefetch: int = 2,
                 start_step: int = 0):
        assert global_batch % host_count == 0
        self.source = source
        self.global_batch = global_batch
        self.rows = global_batch // host_count
        self.seq_len = seq_len
        self.host_id = host_id
        self.host_count = host_count
        self.step = start_step
        self._q: "queue.Queue" = queue.Queue(maxsize=max(prefetch, 1))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    # each host derives its slice from a host-salted step key
    def _make(self, step: int) -> dict:
        raw = self.source.batch(step * self.host_count + self.host_id,
                                self.rows, self.seq_len)
        return {"tokens": raw[:, :-1], "targets": raw[:, 1:]}

    def _fill(self):
        step = self.step
        while not self._stop.is_set():
            try:
                self._q.put((step, self._make(step)), timeout=0.2)
                step += 1
            except queue.Full:
                continue

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        step, batch = self._q.get()
        # drop stale prefetches after a restore
        while step < self.step:
            step, batch = self._q.get()
        self.step = step + 1
        return batch

    # ------------------------------------------------------ checkpointing
    def state_dict(self) -> dict:
        return {"step": self.step}

    def load_state_dict(self, state: dict):
        self.step = int(state["step"])

    def close(self):
        self._stop.set()
