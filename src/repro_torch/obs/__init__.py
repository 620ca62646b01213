"""Observability: the Eq. 1 stall ledger (every modeled stalled second,
attributed to one component). The tracer and metrics registry wait for a
later slice of the port."""
from .ledger import COMPONENTS, StallLedger, tenant_of_key

__all__ = ["COMPONENTS", "StallLedger", "tenant_of_key"]
