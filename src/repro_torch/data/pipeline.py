"""Deterministic synthetic token pipeline with per-host sharding + prefetch
(the port's copy of ``repro.data.pipeline``: numpy only, the same batches
for the same seed).

The workload is a seeded order-1 Markov chain over the vocabulary — learnable
structure (a model that trains will push loss well below ln(vocab)) while
requiring no external data.  ``ShardedLoader`` yields each host its disjoint
slice of the global batch (multi-host data parallelism) and prefetches the
next batch on a background thread so host-side generation overlaps device
compute.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np


class MarkovSource:
    """Seeded Markov chain text source; identical stream for a given seed."""

    def __init__(self, vocab: int, seed: int = 0, branching: int = 4):
        self.vocab = vocab
        rng = np.random.default_rng(seed)
        # each token has `branching` likely successors
        self.succ = rng.integers(0, vocab, size=(vocab, branching))
        self.noise = 0.05

    def sample(self, rng: np.random.Generator, batch: int, seq: int) -> np.ndarray:
        out = np.empty((batch, seq + 1), np.int32)
        out[:, 0] = rng.integers(0, self.vocab, size=batch)
        for t in range(seq):
            branch = rng.integers(0, self.succ.shape[1], size=batch)
            nxt = self.succ[out[:, t], branch]
            flip = rng.random(batch) < self.noise
            nxt = np.where(flip, rng.integers(0, self.vocab, size=batch), nxt)
            out[:, t + 1] = nxt
        return out


class ShardedLoader:
    """Yields {'tokens','labels'} host-local batches, prefetched."""

    def __init__(self, vocab: int, global_batch: int, seq_len: int,
                 host_id: int = 0, n_hosts: int = 1, seed: int = 0,
                 prefetch: int = 2):
        assert global_batch % n_hosts == 0
        self.local_batch = global_batch // n_hosts
        self.seq = seq_len
        self.src = MarkovSource(vocab, seed)
        self.host_id, self.n_hosts, self.seed = host_id, n_hosts, seed
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = 0
        while not self._stop.is_set():
            # per-(step, host) seed -> deterministic, disjoint across hosts
            rng = np.random.default_rng(
                (self.seed, step, self.host_id)
            )
            full = self.src.sample(rng, self.local_batch, self.seq)
            batch = {"tokens": full[:, :-1], "labels": full[:, 1:].copy()}
            try:
                self._q.put(batch, timeout=1.0)
                step += 1
            except queue.Full:
                continue

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        return self._q.get()

    def close(self):
        self._stop.set()
