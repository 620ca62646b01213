"""MetricsRegistry — array-backed counters/gauges/histograms plus the
fleet-wide snapshot/reset protocol.

Two jobs in one module because they share a failure mode:

  1. **Metrics.** Counters, gauges and log-bucket histograms with
     per-host / per-tenant label tuples. Storage follows the
     `_ArrayGhost` idiom from `autopilot/reuse.py`: the label -> row
     map is a Python dict, the values live in flat numpy arrays that
     grow by doubling, and histograms take *batch* observes (one
     vectorized bucketize + `np.add.at` per step), cheap enough to stay
     on during a large replay instead of being a benchmark-off switch.

  2. **Component registration.** The stack has several stats-bearing
     components (`TieredStore`, `AsyncTierRuntime`,
     `ShardedTieredStore`, the stall ledger), and a fleet-wide reset
     that chained them by hand would silently skip whichever one it
     forgot. Components register here with a uniform
     ``snapshot_stats()/reset_stats()`` pair;
     `registry.reset()` walks every registered component, so nothing
     can be skipped, and `registry.snapshot()` is the one place to ask
     "what does the whole stack's bookkeeping say right now".
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

Label = Tuple[str, ...]


def _as_label(label: Union[str, Sequence[str], None]) -> Label:
    if label is None:
        return ()
    if isinstance(label, str):
        return (label,)
    return tuple(str(x) for x in label)


class _Labeled:
    """Shared label -> row machinery (the `_ArrayGhost` idiom: dict for
    hashing, flat arrays for the values)."""

    def __init__(self, name: str, width: int = 1):
        self.name = name
        self._width = width
        cap0 = 8
        self._vals = np.zeros((cap0, width), np.float64)
        self._row: Dict[Label, int] = {}

    def _rowof(self, label: Label) -> int:
        r = self._row.get(label)
        if r is None:
            r = len(self._row)
            if r >= self._vals.shape[0]:
                self._vals = np.concatenate(
                    [self._vals, np.zeros_like(self._vals)])
            self._row[label] = r
        return r

    def labels(self) -> List[Label]:
        return sorted(self._row)

    def reset(self) -> None:
        self._vals[:] = 0.0


class Counter(_Labeled):
    """Monotone per-label accumulator."""

    def inc(self, label=None, v: float = 1.0) -> None:
        # resolve the row BEFORE indexing: _rowof may grow (replace)
        # self._vals, and `self._vals[...] += v` binds the old array
        # before the call
        r = self._rowof(_as_label(label))
        self._vals[r, 0] += v

    def value(self, label=None) -> float:
        r = self._row.get(_as_label(label))
        return 0.0 if r is None else float(self._vals[r, 0])

    def as_dict(self) -> Dict[str, float]:
        return {"/".join(lb) if lb else "": float(self._vals[r, 0])
                for lb, r in sorted(self._row.items())}


class Gauge(Counter):
    """Last-write-wins per-label value."""

    def set(self, label=None, v: float = 0.0) -> None:
        r = self._rowof(_as_label(label))      # may grow self._vals
        self._vals[r, 0] = v

    inc = Counter.inc    # gauges may also accumulate (e.g. occupancy)


class Histogram(_Labeled):
    """Log-bucket histogram: bucket b covers
    [tau0 * 2^b, tau0 * 2^(b+1)), bucket 0 also absorbs everything
    below tau0 (and exact zeros). One row of bucket counts per label;
    `observe_batch` is a single digitize + `np.add.at`."""

    def __init__(self, name: str, n_buckets: int = 32,
                 tau0: float = 1e-6):
        super().__init__(name, width=n_buckets)
        self.n_buckets = int(n_buckets)
        self.tau0 = float(tau0)
        self._count = Counter(name + "_count")
        self._sum = Counter(name + "_sum")

    def _bucketize(self, vals: np.ndarray) -> np.ndarray:
        with np.errstate(divide="ignore"):
            b = np.floor(np.log2(np.maximum(vals, 0.0) / self.tau0))
        return np.clip(np.where(np.isfinite(b), b, 0), 0,
                       self.n_buckets - 1).astype(np.int64)

    def observe(self, v: float, label=None) -> None:
        self.observe_batch(np.asarray([v], np.float64), label)

    def observe_batch(self, vals, label=None) -> None:
        vals = np.asarray(vals, np.float64)
        if vals.size == 0:
            return
        r = self._rowof(_as_label(label))
        np.add.at(self._vals[r], self._bucketize(vals), 1.0)
        self._count.inc(label, float(vals.size))
        self._sum.inc(label, float(vals.sum()))

    def count(self, label=None) -> float:
        return self._count.value(label)

    def sum(self, label=None) -> float:
        return self._sum.value(label)

    def quantile(self, q: float, label=None) -> Optional[float]:
        """Bucket-center quantile (same scheme as the reuse sketch);
        None when the label has no observations."""
        r = self._row.get(_as_label(label))
        if r is None:
            return None
        row = self._vals[r]
        total = float(row.sum())
        if total <= 0.0:
            return None
        cum = np.cumsum(row)
        b = int(np.searchsorted(cum, q * total, side="left"))
        return float(self.tau0 * 2.0 ** (min(b, self.n_buckets - 1)
                                         + 0.5))

    def as_dict(self) -> Dict[str, Dict[str, float]]:
        out: Dict[str, Dict[str, float]] = {}
        for lb, r in sorted(self._row.items()):
            key = "/".join(lb) if lb else ""
            out[key] = {"count": self._count.value(lb),
                        "sum": self._sum.value(lb),
                        "p50": self.quantile(0.5, lb) or 0.0,
                        "p99": self.quantile(0.99, lb) or 0.0}
        return out

    def reset(self) -> None:
        super().reset()
        self._count.reset()
        self._sum.reset()


class MetricsRegistry:
    """Named metrics + registered stats-bearing components, one
    `snapshot()`/`reset()` for the whole stack."""

    def __init__(self):
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._hists: Dict[str, Histogram] = {}
        self._components: Dict[str, object] = {}

    # -------------------------------------------------------------- metrics
    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter(name)
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge(name)
        return g

    def histogram(self, name: str, n_buckets: int = 32,
                  tau0: float = 1e-6) -> Histogram:
        h = self._hists.get(name)
        if h is None:
            h = self._hists[name] = Histogram(name, n_buckets, tau0)
        return h

    # ----------------------------------------------------------- components
    def register(self, name: str, component) -> None:
        """Register a stats-bearing component. The component must
        implement the protocol — registering is what guarantees a
        fleet-wide reset cannot silently skip it."""
        for attr in ("snapshot_stats", "reset_stats"):
            if not callable(getattr(component, attr, None)):
                raise TypeError(
                    f"component {name!r} lacks {attr}(); the "
                    f"snapshot/reset protocol requires both "
                    f"snapshot_stats() and reset_stats()")
        self._components[name] = component

    def components(self) -> List[str]:
        return sorted(self._components)

    # --------------------------------------------------------- fleet sweeps
    def snapshot(self) -> Dict[str, object]:
        out: Dict[str, object] = {
            "counters": {n: c.as_dict()
                         for n, c in sorted(self._counters.items())},
            "gauges": {n: g.as_dict()
                       for n, g in sorted(self._gauges.items())},
            "histograms": {n: h.as_dict()
                           for n, h in sorted(self._hists.items())},
        }
        out["components"] = {
            n: comp.snapshot_stats()
            for n, comp in sorted(self._components.items())}
        return out

    def reset(self) -> None:
        for c in self._counters.values():
            c.reset()
        for g in self._gauges.values():
            g.reset()
        for h in self._hists.values():
            h.reset()
        for comp in self._components.values():
            comp.reset_stats()
