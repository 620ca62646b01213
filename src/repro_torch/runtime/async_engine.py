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

This is the single-host engine: lanes are the `Tier`s of one
`TieredStore`. The fabric's NIC lanes, the far-memory pool's lanes and
the GPU-direct flash path wait for a later slice of the port.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List

from ..core.policy import Tier
from ..obs.ledger import StallLedger, tenant_of_key
from .clock import ensure_clock
from .service import FixedLatencyModel, Service, SsdQueueModel


@dataclasses.dataclass
class Transfer:
    key: object
    nbytes: int
    tier: object                 # lane key: a Tier
    kind: str                    # "fetch" | "promote" | "demote" | "write"
    issue_t: float
    start_t: float
    done_t: float
    depth_at_issue: int
    seq: int
    gate_miss: bool = False      # flash restore of a priced-out key

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
                 sim_cfg=None, specs=None, ledger=None,
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
        self.models = service_models
        lanes = list(self.models)
        self._free: Dict[object, float] = {t: 0.0 for t in lanes}
        self._inflight: Dict[object, List[Transfer]] = {t: []
                                                        for t in lanes}
        self.qstats: Dict[object, QueueStats] = {t: QueueStats()
                                                 for t in lanes}
        self._seq = itertools.count()
        # the ledger is always on: the conservation law in obs.ledger
        # depends on no wait bypassing it
        self.ledger: StallLedger = (ledger if ledger is not None
                                    else StallLedger())
        self.label = label

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
    def submit(self, tier, key, nbytes: int,
               kind: str = "fetch") -> Transfer:
        now = self.clock.now()
        depth = self.queue_depth(tier)
        svc: Service = self.models[tier].service(nbytes, depth + 1)
        start = max(now, self._free[tier])
        done = start + svc.occupancy + svc.latency
        self._free[tier] = start + svc.occupancy
        tr = Transfer(key=key, nbytes=int(nbytes), tier=tier, kind=kind,
                      issue_t=now, start_t=start, done_t=done,
                      depth_at_issue=depth, seq=next(self._seq))
        self._inflight[tier].append(tr)
        st = self.qstats[tier]
        st.submitted += 1
        st.busy_time += svc.occupancy
        st.bytes_moved += int(nbytes)
        if depth > 0:
            st.miss_under_miss += 1
        st.max_depth = max(st.max_depth, depth + 1)
        return tr

    # ----------------------------------------------------------------- wait
    def wait(self, tr: Transfer) -> float:
        """Block until `tr` completes; returns the stall incurred (zero if
        it already finished in the background)."""
        now = self.clock.now()
        stall = max(0.0, tr.done_t - now)
        if stall:
            self.clock.advance_to(tr.done_t)
            self._attribute_stall(tr, now)
        st = self.qstats[tr.tier]
        st.completed_waits += 1
        st.stall_time += stall
        return stall

    def _attribute_stall(self, tr: Transfer, now: float) -> None:
        """Split the residual wait [now, done_t] into its queue window
        (waiting for the lane to go free) and its service window, both
        charged to the lane's Eq. 1 component: a flash restore of a key
        the economic gate priced out of DRAM is billed to the decision
        (gate_miss_restore), any other flash second to the media. The cut
        point is clamped, so the two pieces telescope to exactly the
        stall."""
        cut = min(max(tr.start_t, now), tr.done_t)
        queue_piece = cut - now
        service_piece = tr.done_t - cut
        if tr.tier == Tier.FLASH:
            lane_comp = ("gate_miss_restore" if tr.gate_miss
                         else "flash_service")
        else:
            lane_comp = "other"
        tenant = tenant_of_key(tr.key)
        if queue_piece:
            self.ledger.add(lane_comp, queue_piece, tenant)
        if service_piece:
            self.ledger.add(lane_comp, service_piece, tenant)

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
        """Per-lane `QueueStats` as plain dicts."""
        return {t.name: dataclasses.asdict(st)
                for t, st in self.qstats.items()}

    # --------------------------------------------------------------- report
    def report(self) -> str:
        lines = []
        for t in self._inflight:
            st = self.qstats[t]
            lines.append(
                f"{t.name:6s} xfers={st.submitted:6d} "
                f"stall={st.stall_time*1e3:9.3f}ms "
                f"busy={st.busy_time*1e3:9.3f}ms "
                f"mum={st.miss_under_miss:5d} maxQ={st.max_depth:3d}")
        return "\n".join(lines)
