"""Deterministic synthetic data pipeline with per-host sharding, resumable
iterator state, and background prefetch.

The reference package's `data/pipeline.py`, copied: pure numpy, so its
batches are byte-identical to the reference's for every (seed, host,
step). The trainer moves each batch to its device.

Production semantics on an offline container: the "dataset" is a
deterministic PRNG token stream (seeded per shard x step), so any host can
regenerate any batch — which makes the pipeline trivially elastic
(restore at step k on a different host count reproduces the same global
batch) and makes checkpoint-resume byte-exact.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0
    structure: float = 0.7     # token self-correlation (learnable signal)


class SyntheticLM:
    """Markov-ish token stream: next token = f(prev) with noise, so CE can
    actually decrease during the example training runs."""

    def __init__(self, cfg: DataConfig):
        assert cfg.global_batch % cfg.n_hosts == 0
        self.cfg = cfg
        self.host_batch = cfg.global_batch // cfg.n_hosts

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 4096 + cfg.host_id)
        B, S = self.host_batch, cfg.seq_len
        noise = rng.integers(0, cfg.vocab, (B, S), np.int64)
        toks = np.empty((B, S), np.int64)
        toks[:, 0] = noise[:, 0]
        keep = rng.random((B, S)) < cfg.structure
        mult = 6364136223846793005
        for t in range(1, S):
            nxt = (toks[:, t - 1] * mult + 1442695040888963407) % cfg.vocab
            toks[:, t] = np.where(keep[:, t], nxt, noise[:, t])
        return {"tokens": toks.astype(np.int32)}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class PrefetchIterator:
    """Background-thread prefetch with explicit, checkpointable position."""

    def __init__(self, ds: SyntheticLM, start_step: int = 0, depth: int = 2):
        self.ds = ds
        self.step = start_step
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._next_to_produce = start_step
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        while not self._stop.is_set():
            batch = self.ds.batch_at(self._next_to_produce)
            self._q.put((self._next_to_produce, batch))
            self._next_to_produce += 1

    def __next__(self):
        step, batch = self._q.get()
        self.step = step + 1          # resume point
        return batch

    def state(self) -> dict:
        return {"step": self.step}

    def close(self):
        self._stop.set()
        try:
            self._q.get_nowait()
        except queue.Empty:
            pass
