"""TieredStore — the paper's break-even analysis driving a live
HBM / host-DRAM / Storage-Next-flash object store.

The tiers are emulated pools (numpy arrays + accounting) with the
calibrated cost/latency model attached from `repro_torch.core`; the
decision logic, movement, hit/miss accounting and capacity pressure are
real.

Placement policy: `core.policy.TieringPolicy` (EMA of observed reuse
intervals vs the calibrated break-even thresholds, with hysteresis).
Capacity pressure triggers demotion of the stalest objects (the policy's
evict_candidates order), so each tier holds exactly the hot set S(T) the
paper's §V analysis prescribes.

Timing model: accesses are *transfers* on an `AsyncTierRuntime`. Flash
fetch latency derives from the calibrated ssdsim queueing engine — it
varies with queue depth instead of being a fixed scalar — and
`get_async` exposes the split issue/wait form so callers (serving
prefetch) can overlap fetches with compute. All timing flows through an
injectable clock (deterministic `VirtualClock` by default).

Admission control (Flashield-style write shielding): when constructed
with `write_shield_depth=k`, a demotion's destination write is *deferred*
while the destination tier has >= k fetches in flight. The object moves
structurally at once; only the queue charge parks in a deferred list,
drained when the read depth falls below the threshold (checked on every
subsequent store operation, or explicitly via `flush_deferred_writes`).

Capacity contract: an object larger than its target tier's capacity is
demoted straight to the first tier that can hold it (ultimately FLASH,
the capacity tier); an object larger than every tier raises ValueError.

Economic admission (autopilot): when the policy exposes `admit_tier`
(see `autopilot.gate.EconomicGate`), every `put` asks it where the
object should land, and a flash fetch of a key the policy reports
`priced_out` is billed to the gate's decision in the stall ledger. A
plain `TieringPolicy` has neither hook and keeps the seed behavior.

Readability gating (conservative rebalance pricing): an `ingest` whose
bytes are still on the wire (`not_before` = the NIC delivery time)
records that arrival horizon, and any fetch of the key issued before it
is gated on it — a mid-rebalance restore pays for the in-flight leg
instead of being served structurally-now at the destination.

A store whose specs configure the fourth tier, GPU_FLASH (the BaM-style
GPU-direct flash path: the same NAND behind an accelerator submission
queue), serves it on its own `GpuDirectQueueModel` lane. GPU_FLASH is an
explicit destination only: warm-tier overflow falls to FLASH, never
sideways, and neither FLASH nor GPU_FLASH evicts. The fleet-shared
far-memory pool is not a tier of this store: `runtime.pool.PooledStore`
sits beside the hosts in the sharded fabric.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.policy import Tier, TieringPolicy
from .async_engine import AsyncTierRuntime, Transfer
from .clock import ensure_clock


def lead_steps_from_estimate(est: float, step_time: float) -> int:
    """Decode steps a prefetch must lead by to cover a fetch estimate
    (`ceil(est / step_time)`, >= 1; 1 when step time is unknown). The
    single definition both the store and fabric lead sizing use."""
    if step_time <= 0:
        return 1
    return max(1, math.ceil(est / step_time))


@dataclasses.dataclass
class TierSpec:
    capacity_bytes: float
    read_bw: float              # bytes/s (for modeled latency accounting)
    read_latency: float         # seconds per access (fixed part)
    # write-path bandwidth when asymmetric (flash program vs read, the
    # pool's ingest lane); None inherits read_bw — the historic behavior
    write_bw: Optional[float] = None

    @property
    def effective_write_bw(self) -> float:
        return self.read_bw if self.write_bw is None else self.write_bw


@dataclasses.dataclass
class TierStats:
    hits: int = 0
    misses: int = 0
    bytes_read: int = 0
    bytes_written: int = 0
    modeled_time: float = 0.0
    stall_time: float = 0.0
    promotions: int = 0
    demotions: int = 0
    prefetch_hits: int = 0      # async fetch finished before wait
    prefetch_late: int = 0      # wait still had to block
    demotions_deferred: int = 0  # demotion writes parked by write shielding
    rebalance_deferred: int = 0  # rebalance ingest writes parked likewise
    deferred_bytes: int = 0      # bytes all parked writes will move

    @property
    def hit_rate(self) -> float:
        n = self.hits + self.misses
        return self.hits / n if n else 0.0


@dataclasses.dataclass
class PendingFetch:
    """Handle for an in-flight `get_async`; `wait()` yields the value and
    records only the *residual* stall (zero when the fetch overlapped).

    `external_done_t` lets a composing layer (the fabric's remote fetch:
    flash + NIC) extend the completion horizon so prefetch hit/late
    classification reflects the full composition, not just this leg."""
    store: "TieredStore"
    key: object
    tier: Tier
    transfer: Transfer
    value: np.ndarray
    external_done_t: Optional[float] = None

    def done(self) -> bool:
        done_t = self.transfer.done_t
        if self.external_done_t is not None:
            done_t = max(done_t, self.external_done_t)
        return self.store.clock.now() >= done_t - 1e-12

    def wait(self) -> np.ndarray:
        self.store._finish_fetch(self)
        return self.value


class TieredStore:
    """Key -> ndarray store spanning three tiers with policy movement."""

    def __init__(self, policy: TieringPolicy,
                 specs: Optional[Dict[Tier, TierSpec]] = None,
                 clock=None, runtime: Optional[AsyncTierRuntime] = None,
                 sim_cfg=None, write_shield_depth: Optional[int] = None,
                 obs=None, ledger=None, label: str = "host0"):
        # defaults: the reference package's modeled host (a TPU v5e's HBM,
        # host DRAM, a Storage-Next SSD), kept so the two packages model
        # the same hierarchy; pass `specs` to model another one
        self.specs = specs or {
            Tier.HBM: TierSpec(16e9, 819e9, 1e-7),
            Tier.DRAM: TierSpec(128e9, 45e9, 5e-7),
            Tier.FLASH: TierSpec(4e12, 7e9, 2e-5),
        }
        self.policy = policy
        if runtime is not None:
            self.runtime = runtime
            self.clock = runtime.clock
        else:
            self.clock = ensure_clock(clock)
            self.runtime = AsyncTierRuntime(clock=self.clock,
                                            specs=self.specs,
                                            sim_cfg=sim_cfg, obs=obs,
                                            ledger=ledger, label=label)
        # the store's observability is its runtime's (one ledger, one
        # label — the runtime is where stall materializes)
        self.obs = self.runtime.obs
        self.ledger = self.runtime.ledger
        self.label = self.runtime.label
        # iteration order is the *configured* tier set, hot-to-cold —
        # never `for t in Tier`: a store compiled without the fourth
        # tier must behave bit-identically whether or not the enum has
        # grown new members
        self.tiers: Tuple[Tier, ...] = tuple(sorted(self.specs))
        self._data: Dict[Tier, Dict[object, np.ndarray]] = {
            t: {} for t in self.tiers}
        self._used = {t: 0 for t in self.tiers}
        self.stats: Dict[Tier, TierStats] = {
            t: TierStats() for t in self.tiers}
        if write_shield_depth is not None and write_shield_depth < 1:
            raise ValueError("write_shield_depth must be >= 1 (a zero "
                             "threshold would shield forever)")
        self.write_shield_depth = write_shield_depth
        # parked (tier, key, nbytes, not_before) — the gate keeps a
        # shielded rebalance write behind its upstream NIC delivery
        self._deferred_writes: List[
            Tuple[Tier, object, int, Optional[float]]] = []
        # key -> wire-arrival horizon of an in-flight rebalance ingest;
        # reads issued before it are gated on it (readability gating)
        self._arrival_t: Dict[object, float] = {}

    # ----------------------------------------------------------------- util
    def tier_of(self, key) -> Optional[Tier]:
        for t in self.tiers:
            if key in self._data[t]:
                return t
        return None

    def used_bytes(self, tier: Tier) -> int:
        # .get: fleet-level callers sum over all Tier members; a tier
        # this store does not configure (gpu_flash, pool) holds nothing
        return self._used.get(tier, 0)

    def keys(self) -> List[object]:
        """All resident keys across tiers (hot-to-cold tier order)."""
        out: List[object] = []
        for t in self.tiers:
            out.extend(self._data[t])
        return out

    def nbytes_of(self, key) -> int:
        cur = self.tier_of(key)
        if cur is None:
            raise KeyError(key)
        return self._data[cur][key].nbytes

    def reset_stats(self):
        """Zero all per-tier `TierStats` and the runtime's `QueueStats`
        without touching structural state (residency, capacity, parked
        deferred writes, in-flight transfers). Benchmarks call this after
        their setup/warm-up phase so repetitions on a reused store don't
        inherit stale counters — the deferral counters in particular
        accumulate across reps otherwise."""
        self.stats = {t: TierStats() for t in self.tiers}
        self.runtime.reset_stats()

    def snapshot_stats(self) -> Dict[str, object]:
        """Per-tier `TierStats` plus the runtime's lane stats, as plain
        dicts (the `MetricsRegistry` snapshot/reset protocol)."""
        out: Dict[str, object] = {
            t.name: dataclasses.asdict(st) for t, st in self.stats.items()}
        out["runtime"] = self.runtime.snapshot_stats()
        return out

    # ------------------------------------------------------------------ api
    def put(self, key, value: np.ndarray, tier: Tier = Tier.DRAM):
        value = np.asarray(value)
        self.flush_deferred_writes()
        cur = self.tier_of(key)
        if cur is not None:
            self._remove(key, cur)
        admit = getattr(self.policy, "admit_tier", None)
        if admit is not None:
            # economic admission: the gate prices the object's tracked
            # reuse estimate against break-even and may demote the
            # requested landing tier (it never promotes past the ask)
            tier = admit(key, tier, now=self.clock.now())
        tier = self._fit_tier(tier, value.nbytes)
        self._ensure_room(tier, value.nbytes)
        self._data[tier][key] = value
        self._used[tier] += value.nbytes
        self.stats[tier].bytes_written += value.nbytes
        self.runtime.submit(tier, key, value.nbytes, kind="write")
        self.policy.observe(key, now=self.clock.now())

    def _issue_fetch(self, key) -> PendingFetch:
        self.flush_deferred_writes()
        cur = self.tier_of(key)
        if cur is None:
            raise KeyError(key)
        for t in self.tiers:
            if t == cur:
                self.stats[t].hits += 1
            elif t < min(cur, Tier.FLASH):
                # tiers warmer than the serving one record a miss; the
                # min() keeps GPU_FLASH from charging FLASH a miss —
                # they are parallel paths to the same NAND, not a
                # warmer/colder pair (no-op for 3-tier stores, where
                # cur never exceeds FLASH)
                self.stats[t].misses += 1
        value = self._data[cur][key]
        tr = self.runtime.submit(cur, key, value.nbytes, kind="fetch",
                                 not_before=self._arrival_gate(key))
        if cur == Tier.FLASH:
            # a flash restore of a key the gate priced out of DRAM is a
            # *policy* cost, not a media cost
            priced_out = getattr(self.policy, "priced_out", None)
            if priced_out is not None and priced_out(key):
                tr.gate_miss = True
        self.stats[cur].bytes_read += value.nbytes
        return PendingFetch(store=self, key=key, tier=cur, transfer=tr,
                            value=value)

    def _finish_fetch(self, pf: PendingFetch, now: Optional[float] = None):
        st = self.stats[pf.tier]
        # a fetch only counts as a prefetch if compute time passed
        # between issue and wait; a same-instant wait is a plain
        # synchronous get and must not pollute the prefetch counters
        if self.clock.now() > pf.transfer.issue_t:
            if pf.done():
                st.prefetch_hits += 1
            else:
                st.prefetch_late += 1
        stall = self.runtime.wait(pf.transfer)
        st.stall_time += stall
        st.modeled_time += pf.transfer.done_t - pf.transfer.issue_t
        now = self.clock.now() if now is None else now
        want = self.policy.observe(pf.key, now=now)
        cur = self.tier_of(pf.key)
        if cur is not None and want != cur and not (
                want == Tier.FLASH and cur == Tier.GPU_FLASH):
            # a FLASH want is satisfied by GPU_FLASH residency: both are
            # the same NAND, and shuttling between the two paths is
            # never what the reuse interval asked for
            self._move(pf.key, cur, want)
        self.flush_deferred_writes()

    def get(self, key, now: Optional[float] = None) -> np.ndarray:
        """Synchronous fetch: blocks the clock for the full queueing-aware
        service time."""
        pf = self._issue_fetch(key)
        self._finish_fetch(pf, now=now)
        return pf.value

    def get_async(self, key) -> PendingFetch:
        """Issue a non-blocking fetch; the caller overlaps compute and
        calls `.wait()` when the value is actually needed."""
        return self._issue_fetch(key)

    def read_for_transfer(self, key, not_before: Optional[float] = None):
        """Raw outbound read for fabric rebalance streaming: occupies the
        resident tier's queue and counts bytes, but is neither a cache
        hit nor a policy observation (rebalance traffic must not promote
        keys or skew hit rates). `not_before` gates the read start (the
        fabric's pacing token bucket); a pending wire arrival of the key
        itself gates it as well. Returns (value, transfer)."""
        cur = self.tier_of(key)
        if cur is None:
            raise KeyError(key)
        value = self._data[cur][key]
        gate = self._arrival_gate(key)
        if not_before is not None:
            gate = not_before if gate is None else max(gate, not_before)
        tr = self.runtime.submit(cur, key, value.nbytes, kind="rebalance",
                                 not_before=gate)
        self.stats[cur].bytes_read += value.nbytes
        return value, tr

    def _arrival_gate(self, key) -> Optional[float]:
        """Readability gate: the NIC-delivery horizon of an in-flight
        rebalance ingest of `key`, if still in the future (entries are
        pruned once passed)."""
        t = self._arrival_t.get(key)
        if t is None:
            return None
        if self.clock.now() >= t - 1e-12:
            del self._arrival_t[key]
            return None
        return t

    def ingest(self, key, value: np.ndarray, tier: Tier = Tier.FLASH,
               not_before: Optional[float] = None):
        """Inbound rebalance placement: the object lands structurally at
        once, but the destination write is subject to write shielding
        exactly like a demotion — while this tier has a read burst in
        flight (depth >= `write_shield_depth`) the queue charge parks in
        the deferred list instead of inflating the burst's tail.
        `not_before` gates an unshielded write on the upstream NIC
        delivery, and also records the key's readability horizon: a
        fetch issued before the bytes arrive is gated on the delivery
        instead of being served structurally-now. No policy observation:
        arrival by rebalance is not a reuse event."""
        value = np.asarray(value)
        cur = self.tier_of(key)
        if cur is not None:
            self._remove(key, cur)
        tier = self._fit_tier(tier, value.nbytes)
        self._ensure_room(tier, value.nbytes)
        if not_before is not None and not_before > self.clock.now():
            self._arrival_t[key] = float(not_before)
        self._data[tier][key] = value
        self._used[tier] += value.nbytes
        st = self.stats[tier]
        st.bytes_written += value.nbytes
        if self._shielded(tier):
            # parked like a deferred demotion write (same flush path)
            # but counted separately so the Flashield stat stays pure;
            # the NIC gate parks with it so a flush after the burst
            # drains still cannot write bytes that have not arrived
            st.rebalance_deferred += 1
            st.deferred_bytes += value.nbytes
            self._deferred_writes.append((tier, key, value.nbytes,
                                          not_before))
            self._trace_deferral("rebalance_write_deferred", tier, key,
                                 value.nbytes)
        else:
            self.runtime.submit(tier, key, value.nbytes, kind="write",
                                not_before=not_before)

    def delete(self, key):
        cur = self.tier_of(key)
        if cur is not None:
            self._remove(key, cur)

    # ------------------------------------------------------------- movement
    def _remove(self, key, tier: Tier):
        v = self._data[tier].pop(key)
        self._used[tier] -= v.nbytes
        # a fresh copy supersedes any pending wire arrival of the key
        self._arrival_t.pop(key, None)
        # a parked deferred write for this key is now stale (the object
        # was deleted, overwritten or moved on): drop it so the shield
        # never submits a phantom write for data that no longer exists
        if self._deferred_writes:
            self._deferred_writes = [e for e in self._deferred_writes
                                     if e[1] != key]
        return v

    def move(self, key, dst: Tier):
        """Queue a movement of `key` to `dst` (non-blocking: structure
        updates now, the transfer streams in the background)."""
        src = self.tier_of(key)
        if src is None:
            raise KeyError(key)
        if src != dst:
            self._move(key, src, dst)

    def _move(self, key, src: Tier, dst: Tier):
        # a tier move does not materialize in-flight bytes: keep the
        # readability gate a pending rebalance ingest recorded
        arrival = self._arrival_t.get(key)
        v = self._remove(key, src)
        if arrival is not None:
            self._arrival_t[key] = arrival
        dst = self._fit_tier(dst, v.nbytes)
        if dst == src:
            # an oversized promotion target redirected back onto the
            # source tier: nothing to move
            self._data[src][key] = v
            self._used[src] += v.nbytes
            return
        self._ensure_room(dst, v.nbytes)
        self._data[dst][key] = v
        self._used[dst] += v.nbytes
        self.stats[dst].bytes_written += v.nbytes
        self.stats[src].bytes_read += v.nbytes
        demote = dst > src
        # movement occupies both queues: the read on the source tier
        # (a promotion out of flash contends with KV prefetches there)
        # and the write on the destination
        self.runtime.submit(src, key, v.nbytes,
                            kind="demote" if demote else "promote")
        if demote and self._shielded(dst):
            st = self.stats[dst]
            st.demotions_deferred += 1
            st.deferred_bytes += v.nbytes
            self._deferred_writes.append((dst, key, v.nbytes, None))
            self._trace_deferral("demotion_write_deferred", dst, key,
                                 v.nbytes)
        else:
            self.runtime.submit(dst, key, v.nbytes, kind="write")
        if demote:
            self.stats[dst].demotions += 1
        else:
            self.stats[dst].promotions += 1

    # ----------------------------------------------------- write shielding
    def _shielded(self, tier: Tier) -> bool:
        return (self.write_shield_depth is not None
                and self.runtime.read_depth(tier) >= self.write_shield_depth)

    def _trace_deferral(self, name: str, tier: Tier, key,
                        nbytes: int) -> None:
        if self.obs is not None and self.obs.tracer is not None:
            t = self.obs.tracer
            t.instant(t.track(self.label, tier.name), name,
                      self.clock.now(), cat="shield",
                      args={"key": str(key), "nbytes": int(nbytes)})

    def flush_deferred_writes(self) -> int:
        """Submit parked demotion writes whose destination read burst has
        drained; returns how many were flushed. Entries for a still-
        shielded tier stay parked (per-tier FIFO order preserved) without
        blocking writes bound for other, unshielded tiers."""
        flushed = 0
        keep: List[Tuple[Tier, object, int, Optional[float]]] = []
        for dst, key, nbytes, not_before in self._deferred_writes:
            if self._shielded(dst):
                keep.append((dst, key, nbytes, not_before))
            else:
                self.runtime.submit(dst, key, nbytes, kind="write",
                                    not_before=not_before)
                flushed += 1
        self._deferred_writes = keep
        return flushed

    @property
    def deferred_writes_pending(self) -> int:
        return len(self._deferred_writes)

    # ------------------------------------------------------------- capacity
    def _fit_tier(self, tier: Tier, nbytes: int) -> Tier:
        """First tier at or below `tier` whose capacity can hold the
        object; raises if even the capacity tier cannot. GPU_FLASH is
        only ever an *explicit* destination — capacity overflow from
        the warm tiers falls through to FLASH, never sideways into the
        accelerator-direct namespace. A GPU_FLASH ask on a store without
        that tier lands on FLASH, the same NAND."""
        for t in self.tiers:
            if t < tier or (t == Tier.GPU_FLASH and tier != Tier.GPU_FLASH):
                continue
            if nbytes <= self.specs[t].capacity_bytes:
                return t
        if (tier == Tier.GPU_FLASH and Tier.FLASH in self.specs
                and nbytes <= self.specs[Tier.FLASH].capacity_bytes):
            return Tier.FLASH
        raise ValueError(
            f"object of {nbytes} bytes exceeds every tier's capacity")

    def _ensure_room(self, tier: Tier, nbytes: int):
        """Demote stalest residents until `nbytes` fits (FLASH never
        evicts — it is the capacity tier). `_fit_tier` has already
        guaranteed the object fits an empty `tier`, so the loop always
        makes progress; the guard raise is defensive."""
        spec = self.specs[tier]
        while self._used[tier] + nbytes > spec.capacity_bytes \
                and tier not in (Tier.FLASH, Tier.GPU_FLASH):
            victims = [k for k in self.policy.evict_candidates(
                           tier, now=self.clock.now())
                       if k in self._data[tier]]
            if not victims:
                victims = list(self._data[tier])
            if not victims:
                raise RuntimeError(
                    f"cannot make room in {tier.name}: empty tier yet "
                    f"{nbytes} bytes exceed capacity {spec.capacity_bytes}")
            self._move(victims[0], tier, Tier(tier + 1))

    # ------------------------------------------------------- prefetch sizing
    def estimate_fetch_seconds(self, key) -> float:
        """Tail-aware estimate of a fetch of `key` issued now: occupancy
        at the tier's current depth plus the open-loop p99 access latency
        when the tier's service model calibrates one (flash), else the
        model's mean. This is what p99-sized prefetch leads are cut from
        — the mean under-sizes the lead exactly when the queue is deep."""
        cur = self.tier_of(key)
        if cur is None:
            raise KeyError(key)
        nbytes = self._data[cur][key].nbytes
        depth = self.runtime.queue_depth(cur) + 1
        model = self.runtime.models[cur]
        svc = model.service(nbytes, depth)
        p99 = getattr(model, "p99", None)
        lat = max(svc.latency, p99(depth)) if callable(p99) else svc.latency
        return svc.occupancy + lat

    def prefetch_lead_steps(self, key, step_time: float) -> int:
        """p99-sized prefetch lead: issue the restore
        `ceil(p99_fetch_estimate / step_time)` decode steps early (>= 1)
        instead of a fixed lead."""
        return lead_steps_from_estimate(self.estimate_fetch_seconds(key),
                                        step_time)

    # ---------------------------------------------------------------- report
    def report(self) -> str:
        lines = []
        for t in self.tiers:
            st = self.stats[t]
            lines.append(
                f"{t.name:6s} used={self._used[t]/2**20:9.1f}MiB "
                f"objs={len(self._data[t]):6d} hit_rate={st.hit_rate:.3f} "
                f"read={st.bytes_read/2**20:9.1f}MiB "
                f"t_model={st.modeled_time*1e3:8.2f}ms "
                f"stall={st.stall_time*1e3:8.2f}ms "
                f"promo={st.promotions} demo={st.demotions}")
        return "\n".join(lines)
