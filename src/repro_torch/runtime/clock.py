"""Clocks for the async tiering runtime.

The runtime's testing contract is **clock injection**: every time-dependent
component (`AsyncTierRuntime`, `TieredStore`, `DecodeEngine`, the tiering
policy's EMA) reads time from an injected clock object instead of
`time.time()`. Tests and benchmarks inject a `VirtualClock` and advance it
explicitly, which makes queueing behavior, promotion/demotion hysteresis
and prefetch overlap fully deterministic and instantaneous to simulate;
production paths inject a `WallClock` so the same code runs against real
time. Wall-clock only ever appears at this edge — nothing below the
runtime API calls `time.*` directly.

All clocks are also callable (returning `now()`) so they satisfy the
legacy `Callable[[], float]` clock parameter of `TieredStore`.
"""
from __future__ import annotations

import time


class VirtualClock:
    """Deterministic simulated clock; time moves only via `advance*`."""

    def __init__(self, t0: float = 0.0):
        self._t = float(t0)

    def now(self) -> float:
        return self._t

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError(f"cannot advance by {dt}")
        self._t += dt
        return self._t

    def advance_to(self, t: float) -> float:
        self._t = max(self._t, float(t))
        return self._t

    def __call__(self) -> float:
        return self._t

    def __repr__(self):
        return f"VirtualClock(t={self._t:.6f})"


class WallClock:
    """Real time. `advance` is a no-op: wall time passes on its own, so a
    blocking wait is represented by the caller actually blocking, not by
    moving the clock."""

    def now(self) -> float:
        return time.monotonic()

    def advance(self, dt: float) -> float:
        return self.now()

    def advance_to(self, t: float) -> float:
        return self.now()

    def __call__(self) -> float:
        return self.now()


class CallableClock:
    """Adapter for an externally-driven `Callable[[], float]` clock (the
    legacy `TieredStore(clock=...)` form). The owner of the callable moves
    time; `advance` therefore cannot and does not."""

    def __init__(self, fn):
        self._fn = fn

    def now(self) -> float:
        return float(self._fn())

    def advance(self, dt: float) -> float:
        return self.now()

    def advance_to(self, t: float) -> float:
        return self.now()

    def __call__(self) -> float:
        return self.now()


def ensure_clock(clock):
    """Normalize None / callable / clock-object into a clock object."""
    if clock is None:
        return VirtualClock()
    if hasattr(clock, "now") and hasattr(clock, "advance"):
        return clock
    if callable(clock):
        return CallableClock(clock)
    raise TypeError(f"not a clock: {clock!r}")
