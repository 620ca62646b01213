"""The Eq. 1 stall ledger: every modeled stalled second, attributed.

The paper's five-minute-rule revisit is an *attribution* argument — it
prices the DRAM-vs-flash decision by splitting each second of engine
time into named components (SSD service, queueing, stalled-engine
rent). The simulator models those seconds but until now only summed
them (`TierStats.stall_time`, `kv_stall_time`); a regression shows up
as "stall went up" with no way to say which queue it came from.

`StallLedger` closes that: every stalled second materialized by
`AsyncTierRuntime.wait` lands in exactly one component, and the
scheduler adds idle-slot time under the identical condition it counts
`slot_idle_steps`, so the ledger obeys a conservation law that tests
enforce to 1e-9 relative:

    sum(components) == kv_stall_time + step_time * slot_idle_steps
                    == per_token_stall * tokens

Components (the Eq. 1 decomposition):

  * ``flash_service``    — SSD occupancy + latency on the flash lane
  * ``nic_queue``        — NIC lane service + queueing behind other
                           flows (minus the incast share below)
  * ``incast``           — the extra NIC seconds attributable to
                           fan-in (topology incast factor > 1)
  * ``interference``     — waiting behind, or gated by, rebalance /
                           repair traffic (write-shield readability
                           gates included)
  * ``gate_miss_restore``— flash restore seconds for keys the
                           EconomicGate priced out of DRAM (the cost
                           of an admission decision, not of the media)
  * ``scheduler_idle``   — decode slots empty while work was pending
  * ``pool_rtt``         — far-memory pool lane seconds: the per-host
                           RTT + fabric-bandwidth lane to the shared
                           pool (the price of pooled DRAM's distance)
  * ``gpu_direct_service``— BaM-style GPU-direct flash path: device
                           service through the accelerator submission
                           queue (no host bounce, so none of these
                           seconds ever appear under ``flash_service``)
  * ``other``            — DRAM/HBM residuals and anything a future
                           lane adds before it is classified; keeping
                           a catch-all is what makes conservation
                           *exact* rather than aspirational

Per-tenant sub-ledgers use the same components, keyed by the tenant
tag carried in the KV key (``("kv", "tenant/idx")``); the SLO budget
burn-rate in `ContinuousScheduler.report` divides a tenant's ledger
total by its declared `p99_stall_budget * tokens`.
"""
from __future__ import annotations

from typing import Dict

COMPONENTS = ("flash_service", "nic_queue", "incast", "interference",
              "gate_miss_restore", "scheduler_idle", "pool_rtt",
              "gpu_direct_service", "other")


class StallLedger:
    """Per-component (and per-tenant) accumulator of modeled stalled
    seconds. Plain float adds — cheap enough to stay on always, which
    is what lets the conservation invariant hold on every run rather
    than only when tracing is enabled."""

    def __init__(self):
        self.totals: Dict[str, float] = {c: 0.0 for c in COMPONENTS}
        self.tenants: Dict[str, Dict[str, float]] = {}

    # ------------------------------------------------------------ recording
    def add(self, component: str, seconds: float,
            tenant: str = "") -> None:
        if seconds == 0.0:
            return
        if component not in self.totals:
            component = "other"
        self.totals[component] += seconds
        if tenant:
            t = self.tenants.get(tenant)
            if t is None:
                t = self.tenants[tenant] = {c: 0.0 for c in COMPONENTS}
            t[component] += seconds

    # ------------------------------------------------------------- reading
    def total(self) -> float:
        return sum(self.totals.values())

    def snapshot(self) -> Dict[str, float]:
        """Copy of the component totals (for delta accounting)."""
        return dict(self.totals)

    def delta_since(self, base: Dict[str, float]) -> Dict[str, float]:
        return {c: self.totals[c] - base.get(c, 0.0) for c in COMPONENTS}

    def tenant_totals(self, tenant: str) -> Dict[str, float]:
        return dict(self.tenants.get(tenant, {c: 0.0 for c in COMPONENTS}))

    def as_dict(self) -> Dict[str, object]:
        d: Dict[str, object] = {c: self.totals[c] for c in COMPONENTS}
        d["total"] = self.total()
        if self.tenants:
            d["tenants"] = {t: dict(v) for t, v in
                            sorted(self.tenants.items())}
        return d

    # ---------------------------------------------- snapshot/reset protocol
    def snapshot_stats(self) -> Dict[str, object]:
        return self.as_dict()

    def reset_stats(self) -> None:
        self.totals = {c: 0.0 for c in COMPONENTS}
        self.tenants = {}


def tenant_of_key(key) -> str:
    """Tenant tag carried by a KV key: ``("kv", "tenant/idx")`` →
    ``"tenant"``; anything else has no tenant attribution."""
    if isinstance(key, tuple) and len(key) == 2 and key[0] == "kv":
        rid = key[1]
        if isinstance(rid, str) and "/" in rid:
            return rid.split("/", 1)[0]
    return ""
