"""Runtime-backed KV store — the paper's §VII-A workload on the shared
async movement engine.

`TimedCuckooStore` fronts a `BlockedCuckooStore` with the same
`AsyncTierRuntime` that serves the LLM-session KV and MoE-expert
workloads: every bucket probe becomes a flash-tier transfer with
queueing-aware service time from the calibrated ssdsim model, hot-pair
cache hits become DRAM transfers, and WAL commits become batched flash
writes. On the runtime's virtual clock this yields modeled GET/PUT
latencies (and stall under load) that respond to queue depth — the thing
the seed's fixed-latency accounting could not express.

`get_many` is the async path: all probes are issued back-to-back (the
flash queue pipelines them, miss-under-miss) and waited at the end —
batched 512B reads, the device-side pattern behind the paper's Fig. 8
throughput claims.

`device` is the wrapped store's: where its table's copy for batched GETs
lives (CUDA unless the caller names another).
"""
from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

from ..core.policy import Tier
from ..runtime.async_engine import AsyncTierRuntime
from .cuckoo import BlockedCuckooStore

BLOCK = 512          # one bucket == one 512B flash block
ITEM = 8             # key+value pair bytes in the scaled-down store


class TimedCuckooStore:
    def __init__(self, n_buckets: int, slots: int = 8,
                 dram_cache_items: int = 0, wal_limit: int = 256,
                 runtime: Optional[AsyncTierRuntime] = None,
                 clock=None, seed: int = 0, device=None):
        self.inner = BlockedCuckooStore(
            n_buckets, slots=slots, dram_cache_items=dram_cache_items,
            wal_limit=wal_limit, seed=seed, device=device)
        self.runtime = runtime or AsyncTierRuntime(clock=clock)
        self.clock = self.runtime.clock

    # ------------------------------------------------------------- internal
    def _charge_delta(self, before) -> List:
        """Submit transfers for the flash blocks the wrapped op touched
        (reads are always kind='fetch' — including a WAL commit's
        read-modify-write reads — writes kind='write')."""
        st = self.inner.stats
        trs = []
        for _ in range(st.block_reads - before[0]):
            trs.append(self.runtime.submit(Tier.FLASH, None, BLOCK,
                                           kind="fetch"))
        for _ in range(st.block_writes - before[1]):
            trs.append(self.runtime.submit(Tier.FLASH, None, BLOCK,
                                           kind="write"))
        return trs

    def _snap(self) -> Tuple[int, int]:
        return (self.inner.stats.block_reads, self.inner.stats.block_writes)

    # ------------------------------------------------------------------ api
    def get(self, key: int) -> Optional[int]:
        """Synchronous GET: blocks the clock for the queueing-aware time
        of its 1-2 bucket reads (or a DRAM hit)."""
        before = self._snap()
        hits0 = self.inner.stats.cache_hits
        val = self.inner.get(key)
        trs = self._charge_delta(before)
        if not trs and self.inner.stats.cache_hits > hits0:
            trs = [self.runtime.submit(Tier.DRAM, key, ITEM, kind="fetch")]
        for tr in trs:
            self.runtime.wait(tr)
        return val

    def get_many(self, keys: Iterable[int]) -> List[Optional[int]]:
        """Batched async GETs: issue every probe, then wait once — deep
        queue, pipelined service, far lower per-op stall than serial."""
        vals, all_trs = [], []
        for key in keys:
            before = self._snap()
            vals.append(self.inner.get(key))
            all_trs.extend(self._charge_delta(before))
        for tr in all_trs:
            self.runtime.wait(tr)
        return vals

    def put(self, key: int, value: int):
        """PUT appends to the WAL (DRAM charge); a triggered commit's
        read-modify-writes stream on the flash queue."""
        before = self._snap()
        self.inner.put(key, value)
        self.runtime.submit(Tier.DRAM, key, ITEM, kind="write")
        self._charge_delta(before)                  # WAL flush, if any

    def flush(self):
        before = self._snap()
        self.inner.flush()
        for tr in self._charge_delta(before):
            self.runtime.wait(tr)

    # ---------------------------------------------------------------- stats
    @property
    def stats(self):
        return self.inner.stats

    def modeled_report(self) -> str:
        return self.runtime.report()
