"""Observability: the Eq. 1 stall ledger (every modeled stalled second,
attributed to one component) and the canonical bench-JSON writer
(`jsonio`). The causal tracer and the metrics registry are not ported
yet (ROADMAP Queue 1 item 0b)."""
from .jsonio import bench_json, canon, write_bench_json
from .ledger import COMPONENTS, StallLedger, tenant_of_key

__all__ = ["COMPONENTS", "StallLedger", "bench_json", "canon",
           "tenant_of_key", "write_bench_json"]
