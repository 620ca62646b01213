"""SSD-resident blocked-Cuckoo KV store (paper §VII-A), runnable.

Design mirrors the paper exactly:
  * the hash table lives entirely on the (emulated) flash tier — one
    bucket == one 512B flash block == `slots` fixed-size KV pairs; there
    is NO DRAM-resident index or metadata,
  * each key maps to two candidate buckets (two independent hashes);
    lookups read 1-2 blocks (expected 1.5 at random),
  * inserts use cuckoo displacement chains instead of discards (load
    factor up to ~0.95 for slots >= 4 per Pagh & Rodler / Kirsch et al.),
  * all available DRAM is a hot-pair cache in front of the table,
  * durability via a write-ahead log that coalesces updates per bucket
    before committing (amortizing read-modify-write).

Inserts, the WAL, the hot-pair cache and displacement chains are host
numpy, so a seed builds the same table as the reference package. The
table's device copy serves batched GETs through the `cuckoo_probe` kernel
(the card's analogue of the 512B random-read path); it is uploaded again
only after a write changed the table.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from .._device import resolve_device
from ..kernels.cuckoo_probe.ops import cuckoo_probe, hash_pair
from ..kernels.cuckoo_probe.ref import reference_cuckoo_probe

_H1 = np.uint32(0x9E3779B1)
_H2 = np.uint32(0x85EBCA77)


def h1(keys: np.ndarray, n_buckets: int) -> np.ndarray:
    k = keys.astype(np.uint32)
    return (((k * _H1) ^ (k >> np.uint32(16)))
            % np.uint32(n_buckets)).astype(np.int64)


def h2(keys: np.ndarray, n_buckets: int) -> np.ndarray:
    k = keys.astype(np.uint32)
    return (((k * _H2) ^ (k >> np.uint32(13)))
            % np.uint32(n_buckets)).astype(np.int64)


@dataclasses.dataclass
class StoreStats:
    gets: int = 0
    puts: int = 0
    inserts: int = 0
    updates: int = 0
    relocations: int = 0
    failed_inserts: int = 0
    block_reads: int = 0
    block_writes: int = 0
    cache_hits: int = 0
    wal_appends: int = 0
    wal_flushes: int = 0


class BlockedCuckooStore:
    """int32 key -> int32 value store (fixed-size pairs, paper's 64B items
    scaled down; the geometry — pairs per 512B block — is preserved).

    `device` holds the table's copy that `get_batch` probes: CUDA unless
    the caller passes another (with no CUDA device and none named, the
    constructor raises)."""

    def __init__(self, n_buckets: int, slots: int = 8,
                 dram_cache_items: int = 0, wal_limit: int = 256,
                 max_chain: int = 64, seed: int = 0, device=None):
        self.device = resolve_device(device)
        self.nb = n_buckets
        self.slots = slots
        self.keys = np.zeros((n_buckets, slots), np.int32)   # 0 = empty
        self.vals = np.zeros((n_buckets, slots), np.int32)
        self.stats = StoreStats()
        self.max_chain = max_chain
        self.rng = np.random.default_rng(seed)
        # DRAM: hot-pair cache only (no index!)
        self.cache_cap = dram_cache_items
        self.cache: Dict[int, int] = {}
        # WAL: pending updates coalesced per bucket
        self.wal_limit = wal_limit
        self.wal: List[Tuple[int, int]] = []
        # keys, vals: views of one device table; None after a write
        self._table: Optional[Tuple[torch.Tensor, torch.Tensor]] = None

    @classmethod
    def from_table(cls, keys: np.ndarray, vals: np.ndarray,
                   stats: Optional[StoreStats] = None,
                   rng_state: Optional[dict] = None, **kw
                   ) -> "BlockedCuckooStore":
        """A store over a copy of an existing table: `keys`/`vals`
        [n_buckets, slots] int32 (0 = empty), e.g. the arrays of the
        reference package's store, and its `StoreStats`. `rng_state`, a
        `store.rng.bit_generator.state` dict, continues that store's
        displacement generator, so later inserts relocate as the source
        store's would. Other keywords go to the constructor."""
        keys = np.array(keys, dtype=np.int32, copy=True)
        vals = np.array(vals, dtype=np.int32, copy=True)
        if keys.shape != vals.shape or keys.ndim != 2:
            raise ValueError(f"keys and vals must both be [n_buckets, "
                             f"slots], got {keys.shape} and {vals.shape}")
        store = cls(keys.shape[0], slots=keys.shape[1], **kw)
        store.keys, store.vals = keys, vals
        if stats is not None:
            store.stats = StoreStats(**dataclasses.asdict(stats))
        if rng_state is not None:
            store.rng.bit_generator.state = rng_state
        return store

    def device_table(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The table's copy on the store's device as (keys, vals), each
        [n_buckets, slots] int32, uploaded again only after a write changed
        the table. Both are views of one [n_buckets, 2 * slots] tensor that
        holds each bucket's keys and then its values in one row (64 bytes
        at 8 slots), so a hit's value comes from device memory with its
        keys (faster than two arrays on the H100: PERF.md, §6)."""
        if self._table is None:
            t = torch.from_numpy(np.concatenate([self.keys, self.vals],
                                                axis=1)).to(self.device)
            self._table = (t[:, :self.slots], t[:, self.slots:])
        return self._table

    # ---------------------------------------------------------------- reads
    def get(self, key: int) -> Optional[int]:
        self.stats.gets += 1
        for k, v in reversed(self.wal):          # WAL is authoritative
            if k == key:
                return v
        if key in self.cache:
            self.stats.cache_hits += 1
            self._cache_touch(key, self.cache[key])
            return self.cache[key]
        for b in (int(h1(np.asarray([key]), self.nb)[0]),
                  int(h2(np.asarray([key]), self.nb)[0])):
            self.stats.block_reads += 1
            hit = np.nonzero(self.keys[b] == key)[0]
            if len(hit):
                val = int(self.vals[b, hit[0]])
                self._cache_touch(key, val)
                return val
        return None

    def get_batch(self, keys: Union[np.ndarray, torch.Tensor],
                  use_kernel: bool = True):
        """Vectorized GET path (misses the WAL/cache layers on purpose —
        this is the raw flash-path benchmark; found flags returned).

        keys [N] int32 as a numpy array (returns numpy found, values) or a
        tensor (returns tensors on the store's device). use_kernel=False
        asks for the plain PyTorch version."""
        self.stats.gets += len(keys)
        self.stats.block_reads += 2 * len(keys)
        as_numpy = not isinstance(keys, torch.Tensor)
        k = torch.as_tensor(np.asarray(keys, np.int32) if as_numpy
                            else keys, device=self.device)
        if k.dtype != torch.int32:
            raise ValueError(f"get_batch: keys must be int32, got {k.dtype}")
        k = k.contiguous()
        bk, bv = self.device_table()
        if use_kernel:
            f, v = cuckoo_probe(k, bk, bv)
        else:
            f, v = reference_cuckoo_probe(k, *hash_pair(k, self.nb), bk, bv)
        if as_numpy:
            return f.cpu().numpy(), v.cpu().numpy()
        return f, v

    # --------------------------------------------------------------- writes
    def put(self, key: int, value: int):
        """Durable write: append to WAL; commit when the WAL fills."""
        assert key != 0, "key 0 is the empty sentinel"
        self.stats.puts += 1
        self.stats.wal_appends += 1
        self.wal.append((key, value))
        if key in self.cache:
            self.cache[key] = value
        if len(self.wal) >= self.wal_limit:
            self.flush()

    def flush(self):
        """Commit WAL entries, coalescing updates that hit the same bucket
        (one read-modify-write per touched bucket, as in the paper)."""
        if not self.wal:
            return
        self._table = None                   # the device copy goes stale
        self.stats.wal_flushes += 1
        latest: Dict[int, int] = {}
        for k, v in self.wal:
            latest[k] = v
        self.wal.clear()
        buckets: Dict[int, List[Tuple[int, int]]] = {}
        karr = np.fromiter(latest.keys(), np.int64)
        b1s = h1(karr, self.nb)
        for k, b in zip(karr, b1s):
            buckets.setdefault(int(b), []).append((int(k), latest[int(k)]))
        for b, items in buckets.items():
            self.stats.block_reads += 1          # read-modify-write
            for k, v in items:
                self._insert_now(k, v)
            self.stats.block_writes += 1

    def _insert_now(self, key: int, value: int):
        b1_, b2_ = (int(h1(np.asarray([key]), self.nb)[0]),
                    int(h2(np.asarray([key]), self.nb)[0]))
        # update in place if present
        for b in (b1_, b2_):
            hit = np.nonzero(self.keys[b] == key)[0]
            if len(hit):
                self.vals[b, hit[0]] = value
                self.stats.updates += 1
                return
        # insert into a free slot
        for b in (b1_, b2_):
            free = np.nonzero(self.keys[b] == 0)[0]
            if len(free):
                self.keys[b, free[0]] = key
                self.vals[b, free[0]] = value
                self.stats.inserts += 1
                return
        # displacement chain
        cur_k, cur_v, b = key, value, b1_
        for _ in range(self.max_chain):
            s = int(self.rng.integers(0, self.slots))
            cur_k, self.keys[b, s] = int(self.keys[b, s]), cur_k
            cur_v, self.vals[b, s] = int(self.vals[b, s]), cur_v
            self.stats.relocations += 1
            self.stats.block_reads += 1
            self.stats.block_writes += 1
            alt1, alt2 = (int(h1(np.asarray([cur_k]), self.nb)[0]),
                          int(h2(np.asarray([cur_k]), self.nb)[0]))
            b = alt2 if b == alt1 else alt1
            free = np.nonzero(self.keys[b] == 0)[0]
            if len(free):
                self.keys[b, free[0]] = cur_k
                self.vals[b, free[0]] = cur_v
                self.stats.inserts += 1
                return
        self.stats.failed_inserts += 1
        raise RuntimeError(
            f"cuckoo insert failed at load factor {self.load_factor():.3f}")

    # ----------------------------------------------------------------- misc
    def _cache_touch(self, key: int, val: int):
        if not self.cache_cap:
            return
        self.cache[key] = val
        while len(self.cache) > self.cache_cap:   # FIFO-ish eviction
            self.cache.pop(next(iter(self.cache)))

    def load_factor(self) -> float:
        return float((self.keys != 0).sum()) / self.keys.size

    def expected_chain_len(self) -> float:
        """Paper's estimate E[L] ~= alpha^(2B) / (1 - alpha^B)."""
        a = self.load_factor()
        B = self.slots
        return a ** (2 * B) / max(1.0 - a ** B, 1e-9)
