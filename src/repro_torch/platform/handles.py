"""Uniform capability handles for the compiled platform.

The runtime grew three async call styles — `TieredStore.get_async` ->
`PendingFetch.wait()`, `AsyncTierRuntime.submit` -> `Transfer`, and the
engines' `prefetch_*`/`resume` pairs. The facade collapses them into
one future idiom:

    h = session.fetch()          # issue, never blocks
    ... overlap compute ...
    blob = h.result()            # block only on the unfinished remainder

`Handle.done()` answers "would result() stall right now"; `result()` is
idempotent (the value is cached after the first wait). Writes return an
already-done Handle — placement is structural-now, the bytes stream
behind compute, exactly the store's non-blocking write contract.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..core.policy import Tier


class Handle:
    """One async future over any runtime pending object (`PendingFetch`,
    the fabric's `RemoteFetch`, or nothing for an already-done write)."""

    __slots__ = ("_pending", "_value", "_resolved")

    def __init__(self, pending=None, value=None):
        self._pending = pending
        self._value = value
        self._resolved = pending is None

    def done(self) -> bool:
        """True iff `result()` would return without stalling."""
        if self._resolved:
            return True
        return bool(self._pending.done())

    def result(self):
        """Block on the unfinished remainder (stall lands in the owning
        store's stats) and return the value; idempotent."""
        if not self._resolved:
            self._value = self._pending.wait()
            self._resolved = True
        return self._value


class KvSession:
    """One session's KV state as a capability: save/fetch/prefetch the
    blob through the fabric from a bound host's vantage point, with the
    uniform `Handle` idiom and p99 prefetch-lead sizing. Obtained from
    `Platform.kv_session(rid, host=...)`."""

    def __init__(self, fabric, rid: str, host: int, replicas: int = 1):
        self.fabric = fabric
        self.rid = rid
        self.host = host
        self.replicas = replicas
        self._pending: Optional[Handle] = None

    @property
    def key(self):
        return ("kv", self.rid)

    def save(self, blob, tier: Tier = Tier.DRAM) -> Handle:
        """Place the session's KV (policy may re-tier the ask); the
        write streams behind compute, so the handle is already done."""
        self._pending = None          # a new blob supersedes any prefetch
        self.fabric.put(self.key, np.asarray(blob), tier=tier,
                        from_host=self.host, replicas=self.replicas)
        return Handle()

    def fetch(self) -> Handle:
        """Issue a fresh async restore from this session's host."""
        return Handle(self.fabric.get_async(self.key,
                                            from_host=self.host))

    def prefetch(self) -> Handle:
        """Idempotent async restore: repeated calls share one in-flight
        fetch until its `result()` is consumed."""
        if self._pending is None or self._pending._resolved:
            self._pending = self.fetch()
        return self._pending

    def resume(self) -> np.ndarray:
        """The prefetch's value, blocking only on the remainder."""
        return self.prefetch().result()

    # ------------------------------------------------------------ queries
    def tier(self) -> Optional[Tier]:
        return self.fabric.tier_of(self.key)

    def preferred_host(self) -> int:
        """Least-loaded holder of the KV replica (locality routing)."""
        return self.fabric.preferred_host(self.key, default=self.host)

    def route(self) -> "KvSession":
        """Rebind to the preferred host, turning a remote restore into a
        local read; returns self for chaining."""
        self.host = self.preferred_host()
        return self

    def lead_steps(self, step_time: float) -> int:
        """p99-sized prefetch lead in decode steps from this vantage."""
        return self.fabric.prefetch_lead_steps(self.key, step_time,
                                               from_host=self.host)
