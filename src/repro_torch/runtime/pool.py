"""PooledStore — the fleet-shared disaggregated far-memory tier.

The paper's hierarchy is per-host: every byte not in local DRAM is a
flash fetch away, so each host provisions DRAM for its *own* peak.
A CXL/far-memory pool breaks that coupling: one fleet-level slab of
DRAM-class memory sits between local DRAM and remote flash, rented at
a *discount* to local DRAM because uncorrelated per-host peaks
statistically multiplex onto one shared provision (the
`break_even_components_pool` column in `core.economics` prices exactly
this). What the pool costs instead of rent is *distance*: every access
crosses a per-host fabric lane with an RTT and a bandwidth share
(`runtime.service.PoolLaneModel`), and those seconds land in the stall
ledger's ``pool_rtt`` component.

Topology and fate-sharing:

  * The pool itself is fleet-level infrastructure: it survives
    `fail_host` (its residency and capacity accounting are untouched).
  * Each attached host owns one lane to the pool; the lane dies with
    its host (`detach_host`) exactly like the host's NIC. In-flight
    transfers on a dead lane are never waited — the requester died.
  * One shared `VirtualClock` and one shared `StallLedger` with the
    rest of the fleet, so pooled stall obeys the same conservation
    invariant as every other component.

Mechanics mirror `TieredStore` where the concepts transfer:

  * `put` records a readability horizon (the ingest write's delivery
    time); a `get_async` issued before the bytes arrive gates on it —
    the same conservative pricing as rebalance ingest.
  * Capacity pressure evicts the least-recently-used resident back to
    its owner's flash through the `on_evict` callback the fabric
    installs (the pool never silently drops bytes).
  * `byte_seconds()` integrates resident bytes over time so benches
    can price pool rent (`rent_factor` x the local DRAM rate) the same
    way they price local DRAM rent.

`ShardedTieredStore` consults the pool between the local-DRAM hit and
the remote-flash composition; admission into the pool is the economic
gate's call (`pool_admit`), not the store's.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..obs.ledger import StallLedger
from .async_engine import AsyncTierRuntime, Transfer
from .clock import ensure_clock
from .service import PoolLaneModel

# lane-key prefix: lanes are ("POOL", host) tuples, which is what the
# runtime's stall attribution keys the pool_rtt component on
POOL_LANE = "POOL"


@dataclasses.dataclass
class PoolStats:
    puts: int = 0
    gets: int = 0
    bytes_in: int = 0
    bytes_out: int = 0
    evictions: int = 0
    evicted_bytes: int = 0
    promotions: int = 0          # pool -> local DRAM (fabric-driven)
    stall_time: float = 0.0


@dataclasses.dataclass
class PooledFetch:
    """Handle for an in-flight pool read; duck-types `PendingFetch`
    (`done()` / `wait()` -> value) so engine/scheduler code paths treat
    a pool restore like any other fetch. `on_wait` is the fabric's
    post-fetch hook (reuse observation + possible promotion out of the
    pool)."""
    pool: "PooledStore"
    key: object
    transfer: Transfer
    value: np.ndarray
    on_wait: Optional[Callable[["PooledFetch"], None]] = None

    def done(self) -> bool:
        return self.transfer.is_done(self.pool.clock.now())

    def wait(self) -> np.ndarray:
        stall = self.pool.runtime.wait(self.transfer)
        self.pool.stats.stall_time += stall
        if self.on_wait is not None:
            cb, self.on_wait = self.on_wait, None
            cb(self)
        return self.value


class PooledStore:
    """One fleet-shared far-memory slab with per-host RTT lanes."""

    def __init__(self, capacity_bytes: float, *, read_bw: float = 40e9,
                 write_bw: Optional[float] = None, rtt: float = 2e-6,
                 sat_depth: int = 4, rent_factor: float = 0.5,
                 clock=None, obs=None, ledger: Optional[StallLedger] = None,
                 label: str = "pool"):
        if capacity_bytes <= 0:
            raise ValueError("pool capacity must be positive")
        self.capacity_bytes = float(capacity_bytes)
        self.rent_factor = float(rent_factor)
        self.lane_model = PoolLaneModel(rtt=rtt, read_bw=read_bw,
                                        write_bw=write_bw,
                                        sat_depth=sat_depth)
        self.clock = ensure_clock(clock)
        self.runtime = AsyncTierRuntime(clock=self.clock,
                                        service_models={}, obs=obs,
                                        ledger=ledger, label=label)
        self.obs = self.runtime.obs
        self.ledger = self.runtime.ledger
        self.label = label
        self.stats = PoolStats()
        self._data: Dict[object, np.ndarray] = {}
        self._used = 0
        self._owner: Dict[object, int] = {}      # host that pooled the key
        self._lru: Dict[object, float] = {}      # key -> last access time
        self._seq = 0                            # LRU tie-break (puts at
        self._lru_seq: Dict[object, int] = {}    # the same instant)
        # key -> wire-arrival horizon of an in-flight ingest; reads
        # issued before it gate on it (readability gating)
        self._arrival_t: Dict[object, float] = {}
        # host id -> lane key, active lanes only; dead lanes keep their
        # runtime queue history (like retired NICs) but route nothing
        self.lanes: Dict[int, Tuple[str, int]] = {}
        # fabric-installed spill path: (key, value, owner_host) -> None;
        # capacity pressure is a *demotion back to flash*, never a drop
        self.on_evict: Optional[Callable[[object, np.ndarray, int],
                                         None]] = None
        # resident byte-seconds integral (pool rent accounting)
        self._bs_accum = 0.0
        self._bs_last_t = self.clock.now()

    # ---------------------------------------------------------------- lanes
    def attach_host(self, host: int) -> None:
        if host in self.lanes:
            return
        lane = (POOL_LANE, int(host))
        self.lanes[host] = lane
        if lane not in self.runtime.models:
            self.runtime.add_lane(lane, self.lane_model)

    def detach_host(self, host: int) -> None:
        """The host's lane dies with the host; pool residency survives.
        The lane's queue history stays on the runtime (stats), it just
        stops being routable."""
        self.lanes.pop(host, None)

    def _lane(self, host: int) -> Tuple[str, int]:
        lane = self.lanes.get(host)
        if lane is None:
            raise KeyError(f"host {host} has no pool lane (not attached "
                           f"or failed)")
        return lane

    # ------------------------------------------------------------ accounting
    def _accrue(self) -> None:
        now = self.clock.now()
        self._bs_accum += self._used * (now - self._bs_last_t)
        self._bs_last_t = now

    def byte_seconds(self) -> float:
        """Resident byte-seconds to date — what pool rent is priced on
        (at `rent_factor` x the local DRAM rate)."""
        self._accrue()
        return self._bs_accum

    def _touch(self, key) -> None:
        self._lru[key] = self.clock.now()
        self._seq += 1
        self._lru_seq[key] = self._seq

    # ------------------------------------------------------------------ api
    def has(self, key) -> bool:
        return key in self._data

    def keys(self) -> List[object]:
        return list(self._data)

    @property
    def used_bytes(self) -> int:
        return self._used

    def nbytes_of(self, key) -> int:
        return self._data[key].nbytes

    def owner_of(self, key) -> Optional[int]:
        return self._owner.get(key)

    def put(self, key, value: np.ndarray, from_host: int) -> Transfer:
        """Place `key` in the pool over `from_host`'s lane (ingest
        write at the lane's write bandwidth). Records the readability
        horizon: a read issued before the bytes arrive gates on the
        write's delivery."""
        value = np.asarray(value)
        lane = self._lane(from_host)
        self._accrue()
        if key in self._data:
            self._remove(key)
        self._ensure_room(value.nbytes, exclude=key)
        tr = self.runtime.submit(lane, key, value.nbytes, kind="write",
                                 ctx={"write": True})
        self._data[key] = value
        self._used += value.nbytes
        self._owner[key] = int(from_host)
        self._touch(key)
        if tr.done_t > self.clock.now():
            self._arrival_t[key] = tr.done_t
        self.stats.puts += 1
        self.stats.bytes_in += value.nbytes
        return tr

    def get_async(self, key, from_host: int,
                  on_wait: Optional[Callable[[PooledFetch], None]] = None
                  ) -> PooledFetch:
        if key not in self._data:
            raise KeyError(key)
        lane = self._lane(from_host)
        value = self._data[key]
        tr = self.runtime.submit(lane, key, value.nbytes, kind="fetch",
                                 not_before=self._arrival_gate(key))
        self._touch(key)
        self.stats.gets += 1
        self.stats.bytes_out += value.nbytes
        return PooledFetch(pool=self, key=key, transfer=tr, value=value,
                           on_wait=on_wait)

    def get(self, key, from_host: int) -> np.ndarray:
        return self.get_async(key, from_host).wait()

    def delete(self, key) -> None:
        if key in self._data:
            self._accrue()
            self._remove(key)

    def _remove(self, key) -> np.ndarray:
        v = self._data.pop(key)
        self._used -= v.nbytes
        self._owner.pop(key, None)
        self._lru.pop(key, None)
        self._lru_seq.pop(key, None)
        self._arrival_t.pop(key, None)
        return v

    def _arrival_gate(self, key) -> Optional[float]:
        t = self._arrival_t.get(key)
        if t is None:
            return None
        if self.clock.now() >= t - 1e-12:
            del self._arrival_t[key]
            return None
        return t

    # ------------------------------------------------------------- capacity
    def _ensure_room(self, nbytes: int, exclude=None) -> None:
        if nbytes > self.capacity_bytes:
            raise ValueError(
                f"object of {nbytes} bytes exceeds the pool capacity "
                f"{self.capacity_bytes:.0f}")
        while self._used + nbytes > self.capacity_bytes:
            victim = min(
                (k for k in self._data if k != exclude),
                key=lambda k: (self._lru[k], self._lru_seq[k]),
                default=None)
            if victim is None:
                raise RuntimeError("pool cannot make room: no victims")
            owner = self._owner.get(victim, 0)
            value = self._remove(victim)
            self.stats.evictions += 1
            self.stats.evicted_bytes += value.nbytes
            if self.on_evict is not None:
                self.on_evict(victim, value, owner)

    # ---------------------------------------------------------------- stats
    def reset_stats(self) -> None:
        self.stats = PoolStats()
        self.runtime.reset_stats()

    def snapshot_stats(self) -> Dict[str, object]:
        out: Dict[str, object] = dataclasses.asdict(self.stats)
        out["keys"] = len(self._data)
        out["used_bytes"] = int(self._used)
        out["lanes"] = self.runtime.snapshot_stats()
        return out

    def drain(self) -> float:
        return self.runtime.drain()

    def report(self) -> str:
        st = self.stats
        return (f"POOL   used={self._used/2**20:9.1f}MiB "
                f"objs={len(self._data):6d} puts={st.puts:6d} "
                f"gets={st.gets:6d} evict={st.evictions:5d} "
                f"promo={st.promotions:5d} "
                f"stall={st.stall_time*1e3:8.2f}ms")
