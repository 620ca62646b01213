"""Deterministic observability plane on the `VirtualClock`.

Three parts, one holder:

  * `Tracer` (`obs.trace`) — causally-linked spans + policy-decision
    instants, exported as byte-stable Perfetto/Chrome `trace_event`
    JSON and a folded-stack flamegraph of modeled time.
  * `MetricsRegistry` (`obs.metrics`) — array-backed counters / gauges
    / log-bucket histograms with per-host and per-tenant labels, plus
    the fleet-wide `snapshot_stats()/reset_stats()` component registry.
  * `StallLedger` (`obs.ledger`) — every modeled stalled second
    attributed to exactly one Eq. 1 component (the components sum to
    the total).

`Observability` bundles the three so one object threads through the
stack (`HierarchySpec.observability` -> `Platform.compile` ->
`ShardedTieredStore` -> per-host runtimes -> engines). The ledger is
always present (plain float adds — the conservation law holds on every
run); tracing and metrics are knobs, off and on by default.
"""
from __future__ import annotations

from typing import Optional

from .jsonio import bench_json, canon, write_bench_json
from .ledger import COMPONENTS, StallLedger, tenant_of_key
from .metrics import Counter, Gauge, Histogram, MetricsRegistry
from .trace import Tracer

__all__ = [
    "COMPONENTS", "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "Observability", "StallLedger", "Tracer", "bench_json", "canon",
    "tenant_of_key", "write_bench_json",
]


class Observability:
    """tracer (optional) + metrics (optional) + ledger (always)."""

    def __init__(self, trace: bool = False, metrics: bool = True,
                 max_events: int = 200_000):
        self.tracer: Optional[Tracer] = (
            Tracer(max_events=max_events) if trace else None)
        self.metrics: Optional[MetricsRegistry] = (
            MetricsRegistry() if metrics else None)
        self.ledger = StallLedger()
        if self.metrics is not None:
            self.metrics.register("stall_ledger", self.ledger)

    def snapshot_stats(self) -> dict:
        if self.metrics is not None:
            return self.metrics.snapshot()
        return {"components": {
            "stall_ledger": self.ledger.snapshot_stats()}}

    def reset_stats(self) -> None:
        """Fleet-wide reset through the registry — every registered
        component, the metrics arrays, and the ledger in one sweep."""
        if self.metrics is not None:
            self.metrics.reset()      # includes the ledger (registered)
        else:
            self.ledger.reset_stats()
