"""AsyncTierRuntime — event-driven, queueing-aware tier movement engine.

It turns tier accesses into *transfers* with explicit issue/start/done
timestamps on an injectable clock (see `runtime.clock` for the
clock-injection testing contract):

  * `submit` schedules a transfer: the tier's service model (calibrated
    from the ssdsim DES for flash — see `runtime.service`) yields an
    occupancy and a pipelined latency for the current queue depth;
    occupancies serialize on the tier (queueing), latencies overlap.
  * `wait` blocks the virtual clock until the transfer completes and
    returns the stall actually incurred — zero when enough compute time
    was overlapped after `submit` (that difference is the whole point of
    async prefetch).
  * `advance` models compute proceeding while transfers stream in the
    background (a decode step).

Per-tier `QueueStats` record stall time and miss-under-miss occupancy so
benchmarks can report modeled per-token stall under load. Every stalled
second `wait` materializes lands in the `StallLedger`.

Queues are keyed by *lane*: any hashable key with a service model. The
single-host `TieredStore` uses the `Tier` enum; the sharded fabric
(`runtime.fabric`) adds per-host NIC lanes with a `NetQueueModel` on the
same engine. `submit(..., not_before=t)` lets a transfer's start be
gated on an upstream completion, which is how a remote fetch composes
the remote host's flash service with the network service (the NIC
transfer cannot start before the flash read delivers the bytes).
The far-memory pool (`runtime.pool`) keys its per-host lanes
``("POOL", host)`` with a `PoolLaneModel`, and a store that configures
the GPU_FLASH tier gets a `GpuDirectQueueModel` lane over the same
calibrated NAND; each bills its own stall-ledger component.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional

from ..core.policy import Tier
from ..obs.ledger import StallLedger, tenant_of_key
from .clock import ensure_clock
from .service import (FixedLatencyModel, GpuDirectQueueModel, Service,
                      SsdQueueModel)


@dataclasses.dataclass
class Transfer:
    key: object
    nbytes: int
    tier: object                 # lane key: a Tier, or e.g. a NIC lane
    kind: str                    # "fetch" | "promote" | "demote" | "write"
    issue_t: float
    start_t: float
    done_t: float
    depth_at_issue: int
    seq: int
    # ---- stall-ledger attribution (set at submit / by the fabric) ----
    gate_t: Optional[float] = None   # upstream not_before horizon
    behind_interference: bool = False  # queued behind rebalance/repair
    incast_frac: float = 0.0         # NIC: share of service due to fan-in
    gate_miss: bool = False          # flash restore of a priced-out key

    def is_done(self, now: float) -> bool:
        return now >= self.done_t - 1e-12


@dataclasses.dataclass
class QueueStats:
    submitted: int = 0
    completed_waits: int = 0
    stall_time: float = 0.0
    busy_time: float = 0.0
    bytes_moved: int = 0
    miss_under_miss: int = 0     # submits issued while others in flight
    max_depth: int = 0


class AsyncTierRuntime:
    # the reference package's modeled host (TieredStore's default specs)
    DEFAULT_MODELS = {
        Tier.HBM: FixedLatencyModel(1e-7, 819e9),
        Tier.DRAM: FixedLatencyModel(5e-7, 45e9),
    }

    def __init__(self, clock=None, service_models=None,
                 sim_cfg=None, specs=None, obs=None, ledger=None,
                 label: str = "host0"):
        self.clock = ensure_clock(clock)
        if service_models is None:
            service_models = dict(self.DEFAULT_MODELS)
            if specs:
                for t, spec in specs.items():
                    service_models[t] = FixedLatencyModel(
                        spec.read_latency, spec.read_bw)
            # flash service always derives from the ssdsim queueing
            # engine unless the caller explicitly injected a model
            service_models[Tier.FLASH] = SsdQueueModel.shared(sim_cfg)
            if specs and Tier.GPU_FLASH in specs:
                # the BaM-style path reuses the same calibrated NAND
                # ladder behind an accelerator submission queue — a
                # different lane on the same engine, never contending
                # with the host-flash lane's queue
                service_models[Tier.GPU_FLASH] = GpuDirectQueueModel(
                    SsdQueueModel.shared(sim_cfg))
        self.models = service_models
        lanes = list(self.models)
        self._free: Dict[object, float] = {t: 0.0 for t in lanes}
        self._inflight: Dict[object, List[Transfer]] = {t: []
                                                        for t in lanes}
        self.qstats: Dict[object, QueueStats] = {t: QueueStats()
                                                 for t in lanes}
        self._seq = itertools.count()
        # observability: the ledger is always on (every stalled second
        # `wait` materializes is attributed — the conservation law in
        # obs.ledger depends on no wait bypassing it); tracer/metrics
        # only when an Observability is attached
        self.obs = obs
        self.ledger: StallLedger = (
            ledger if ledger is not None
            else (obs.ledger if obs is not None else StallLedger()))
        self.label = label

    # ----------------------------------------------------------------- lanes
    def add_lane(self, lane, model) -> None:
        """Register a new lane (key + service model) on a live runtime,
        as a far-memory pool attaches a per-host lane when a host joins
        the fleet. Re-registering an existing lane key is a
        programming error (it would silently reset its queue)."""
        if lane in self.models:
            raise ValueError(f"lane {lane!r} already registered")
        self.models[lane] = model
        self._free[lane] = 0.0
        self._inflight[lane] = []
        self.qstats[lane] = QueueStats()

    # ----------------------------------------------------------------- time
    def now(self) -> float:
        return self.clock.now()

    def advance(self, dt: float) -> float:
        """Model `dt` seconds of compute overlapping in-flight transfers."""
        return self.clock.advance(dt)

    # ---------------------------------------------------------------- queue
    def _prune(self, tier):
        now = self.clock.now()
        self._inflight[tier] = [tr for tr in self._inflight[tier]
                                if not tr.is_done(now)]

    def queue_depth(self, tier) -> int:
        self._prune(tier)
        return len(self._inflight[tier])

    def read_depth(self, tier) -> int:
        """In-flight fetches on `tier` — the queue-depth forecast behind
        write shielding (a fetch not yet done will still be contending
        when a write submitted now would start)."""
        self._prune(tier)
        return sum(1 for tr in self._inflight[tier] if tr.kind == "fetch")

    # --------------------------------------------------------------- submit
    def submit(self, tier, key, nbytes: int, kind: str = "fetch",
               not_before: Optional[float] = None,
               ctx: Optional[dict] = None) -> Transfer:
        now = self.clock.now()
        depth = self.queue_depth(tier)
        # `ctx` carries service context a model may be keyed on beyond
        # queue depth (the topology-aware NIC model's src/dst/fan_in);
        # models that don't take it are simply never handed one
        if ctx:
            svc: Service = self.models[tier].service(nbytes, depth + 1,
                                                     **ctx)
        else:
            svc = self.models[tier].service(nbytes, depth + 1)
        start = max(now, self._free[tier])
        if not_before is not None:
            # gate on an upstream completion (cross-host composition:
            # the NIC transfer starts when the remote flash read is done)
            start = max(start, float(not_before))
        done = start + svc.occupancy + svc.latency
        self._free[tier] = start + svc.occupancy
        # queued behind rebalance/repair traffic already on this lane:
        # any later stall in the queue window is interference, not the
        # lane's own service — recorded now, while the culprits are
        # still observable in flight
        behind = any(t.kind in ("rebalance", "repair")
                     for t in self._inflight[tier])
        tr = Transfer(key=key, nbytes=int(nbytes), tier=tier, kind=kind,
                      issue_t=now, start_t=start, done_t=done,
                      depth_at_issue=depth, seq=next(self._seq),
                      gate_t=(None if not_before is None
                              else float(not_before)),
                      behind_interference=behind)
        self._inflight[tier].append(tr)
        st = self.qstats[tier]
        st.submitted += 1
        st.busy_time += svc.occupancy
        st.bytes_moved += int(nbytes)
        if depth > 0:
            st.miss_under_miss += 1
        st.max_depth = max(st.max_depth, depth + 1)
        if self.obs is not None:
            self._observe_submit(tr, depth)
        return tr

    def _lane_name(self, tier) -> str:
        return getattr(tier, "name", str(tier))

    def _observe_submit(self, tr: Transfer, depth: int) -> None:
        lane = self._lane_name(tr.tier)
        m = self.obs.metrics
        if m is not None:
            m.counter("transfers").inc((self.label, lane, tr.kind))
            m.counter("bytes_moved").inc((self.label, lane), tr.nbytes)
        t = self.obs.tracer
        if t is not None:
            track = t.track(self.label, lane)
            t.complete(track, tr.kind, tr.start_t,
                       tr.done_t - tr.start_t, cat="transfer",
                       args={"key": str(tr.key), "nbytes": tr.nbytes,
                             "depth": depth, "issue_t": tr.issue_t})

    # ----------------------------------------------------------------- wait
    def wait(self, tr: Transfer) -> float:
        """Block until `tr` completes; returns the stall incurred (zero if
        it already finished in the background)."""
        now = self.clock.now()
        stall = max(0.0, tr.done_t - now)
        if stall:
            self.clock.advance_to(tr.done_t)
            self._attribute_stall(tr, now, stall)
        st = self.qstats[tr.tier]
        st.completed_waits += 1
        st.stall_time += stall
        return stall

    def _attribute_stall(self, tr: Transfer, now: float,
                         stall: float) -> None:
        """Decompose the residual wait [now, done_t] into Eq. 1 ledger
        components. The cut points are clamped and monotone, so the
        three pieces telescope to exactly `stall` — that exactness is
        what the conservation test leans on."""
        # gate window: waiting for an upstream horizon (write-shield /
        # ingest readability, rebalance pacing) — interference. For a
        # transfer gated on another transfer's completion that was
        # itself waited first (the remote-fetch NIC leg), the clock is
        # already at gate_t and this window is empty.
        c1 = min(max(tr.gate_t, now), tr.done_t) \
            if tr.gate_t is not None else now
        # queue window: waiting for the lane to go free
        c2 = min(max(tr.start_t, c1), tr.done_t)
        gate_piece = c1 - now
        queue_piece = c2 - c1
        service_piece = tr.done_t - c2
        if isinstance(tr.tier, Tier):
            if tr.tier == Tier.FLASH:
                lane_comp = ("gate_miss_restore" if tr.gate_miss
                             else "flash_service")
            elif tr.tier == Tier.GPU_FLASH:
                # the accelerator-direct path never rides the host
                # flash lane, so none of its seconds may land under
                # flash_service — its own Eq. 1 column
                lane_comp = "gpu_direct_service"
            else:
                lane_comp = "other"          # DRAM/HBM residuals
        elif isinstance(tr.tier, tuple) and tr.tier \
                and tr.tier[0] == "POOL":
            lane_comp = "pool_rtt"           # per-host far-memory lanes
        else:
            lane_comp = "nic_queue"          # NIC (or future) lanes
        tenant = tenant_of_key(tr.key)
        led = self.ledger
        if gate_piece:
            led.add("interference", gate_piece, tenant)
        if queue_piece:
            led.add("interference" if tr.behind_interference
                    else lane_comp, queue_piece, tenant)
        if service_piece:
            inc = service_piece * tr.incast_frac
            if inc:
                led.add("incast", inc, tenant)
            led.add(lane_comp, service_piece - inc, tenant)
        obs = self.obs
        if obs is not None and obs.tracer is not None:
            track = obs.tracer.track(self.label, self._lane_name(tr.tier))
            obs.tracer.instant(
                track, "stall", now, cat="stall",
                args={"key": str(tr.key), "stall": stall,
                      "gate": gate_piece, "queue": queue_piece,
                      "service": service_piece, "component": lane_comp})
        if obs is not None and obs.metrics is not None:
            obs.metrics.histogram("stall_seconds").observe(
                stall, (self.label, self._lane_name(tr.tier)))

    def drain(self, tier=None) -> float:
        """Advance to the completion of all in-flight transfers."""
        tiers = [tier] if tier is not None else list(self._inflight)
        t_done = self.clock.now()
        for t in tiers:
            for tr in self._inflight[t]:
                t_done = max(t_done, tr.done_t)
        self.clock.advance_to(t_done)
        for t in tiers:
            self._prune(t)
        return t_done

    def reset_stats(self):
        """Fresh `QueueStats` on every lane; in-flight transfers and lane
        free times are structural state and stay untouched."""
        self.qstats = {t: QueueStats() for t in self.qstats}

    def snapshot_stats(self) -> Dict[str, Dict[str, float]]:
        """Per-lane `QueueStats` as plain dicts (the
        `MetricsRegistry` snapshot/reset protocol)."""
        return {self._lane_name(t): dataclasses.asdict(st)
                for t, st in self.qstats.items()}

    # --------------------------------------------------------------- report
    def report(self) -> str:
        lines = []
        for t in self._inflight:
            st = self.qstats[t]
            name = getattr(t, "name", str(t))
            lines.append(
                f"{name:6s} xfers={st.submitted:6d} "
                f"stall={st.stall_time*1e3:9.3f}ms "
                f"busy={st.busy_time*1e3:9.3f}ms "
                f"mum={st.miss_under_miss:5d} maxQ={st.max_depth:3d}")
        return "\n".join(lines)
