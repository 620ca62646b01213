"""ReuseTracker — online per-key-class reuse-interval estimation.

Two structures, both O(1) per access:

  * a **ghost cache**: key -> last-seen time, kept even after the object
    is evicted from every tier (bounded size, FIFO on last touch). The
    ghost is what turns a re-admission into a *measured* reuse interval
    instead of a first touch — Flashield's trick, pointed at economics:
    without it every flood re-entry looks new and admission cannot
    distinguish "was here, came back fast" from "never seen".
  * a per-class **decayed log-bucket interval histogram** (the sketch):
    bucket b covers [tau0 * 2^b, tau0 * 2^(b+1)); each observed interval
    increments its (class, bucket) cell and the whole sketch ages by
    `decay` per batch, so estimates track drift (diurnal shifts,
    tenant bursts). Classes are caller-defined strings — "kv" sessions,
    "expert" weights, per-tenant streams — registered on first use.

The batched update runs the `kernels/reuse_sketch` wrapper on the
tracker's device: the hand-written CUDA kernel for a CUDA histogram (one
launch for thousands of keys per decode step), the plain PyTorch version
for a CPU one. Both give the reference's numpy oracle bit for bit. The
ghost stays on the host (a Python key dict and numpy arrays, as in the
reference); the estimates copy one class row to the host and run numpy.

Class quantiles of the sketch answer "what reuse interval should I
assume for a key I know nothing about" (the EconomicGate's first-touch
prior) and, expanded to a weighted sample, feed `core.workload`'s
EmpiricalWorkload for the ProvisionAdvisor's threshold analysis.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from .._device import resolve_device
from ..kernels.reuse_sketch.ops import reuse_sketch_update


class _ArrayGhost:
    """Array-backed ghost state: the key -> row map stays a Python dict
    (arbitrary keys must hash somewhere), but last-seen times and touch
    sequence live in flat numpy arrays, so a batch touch is one
    vectorized pass instead of per-key OrderedDict churn — the
    difference between 1e3 and 1e6 tracked keys per step.

    Semantics match the old OrderedDict ghost exactly for any batch
    that fits inside the capacity headroom: first-ever touch measures
    0.0, a duplicate within one batch measures the 1e-9 floor, and a
    re-touch measures max(now - last, 1e-9). The one deliberate
    difference: eviction (FIFO on last touch == smallest touch
    sequence) is enforced per *batch*, not per element, so a single
    batch larger than the capacity can measure against entries the
    element-at-a-time code would already have evicted mid-batch. Size
    the ghost above the per-step batch (every real config does) and
    the two are indistinguishable."""

    def __init__(self, capacity: int):
        self.capacity = int(capacity)
        cap0 = 1024
        self._times = np.zeros(cap0, np.float64)
        self._seq = np.zeros(cap0, np.int64)
        self._occ = np.zeros(cap0, bool)
        self._keys: List[object] = [None] * cap0
        self._row: Dict[object, int] = {}
        self._free: List[int] = list(range(cap0 - 1, -1, -1))
        self._next_seq = 0

    def __len__(self) -> int:
        return len(self._row)

    def __contains__(self, key) -> bool:
        return key in self._row

    def get(self, key, default=None):
        r = self._row.get(key)
        return default if r is None else float(self._times[r])

    def discard(self, key) -> None:
        r = self._row.pop(key, None)
        if r is not None:
            self._occ[r] = False
            self._keys[r] = None
            self._free.append(r)

    def _grow(self, need: int) -> None:
        cap = len(self._times)
        if need <= cap:
            return
        new = cap
        while new < need:
            new *= 2
        pad = new - cap
        self._times = np.concatenate(
            [self._times, np.zeros(pad, np.float64)])
        self._seq = np.concatenate([self._seq, np.zeros(pad, np.int64)])
        self._occ = np.concatenate([self._occ, np.zeros(pad, bool)])
        self._keys.extend([None] * pad)
        self._free.extend(range(new - 1, cap - 1, -1))

    def touch_batch(self, keys: Sequence[object],
                    now: float) -> np.ndarray:
        """Touch a batch at one timestamp; returns float32 measured
        intervals (0.0 where the key was brand new)."""
        n = len(keys)
        self._grow(len(self._row) + n)
        rows = np.empty(n, np.int64)
        new = np.zeros(n, bool)
        dup = np.zeros(n, bool)
        seen = set()
        for i, key in enumerate(keys):
            r = self._row.get(key)
            if r is None:
                r = self._free.pop()
                self._row[key] = r
                self._keys[r] = key
                self._occ[r] = True
                self._times[r] = now
                new[i] = True
            elif key in seen:
                dup[i] = True
            rows[i] = r
            seen.add(key)
        iv = np.maximum(now - self._times[rows], 1e-9)
        iv = np.where(dup, 1e-9, iv)
        iv = np.where(new, 0.0, iv)
        # touch order: the key's *last* occurrence in the batch decides
        # its sequence (OrderedDict move-to-end semantics). Fancy
        # assignment with duplicate indices has no ordering guarantee,
        # so pick the last occurrence explicitly via reversed unique.
        u, pos_rev = np.unique(rows[::-1], return_index=True)
        self._times[u] = now
        self._seq[u] = self._next_seq + (n - 1 - pos_rev)
        self._next_seq += n
        self._evict()
        return iv.astype(np.float32)

    def _evict(self) -> None:
        over = len(self._row) - self.capacity
        if over <= 0:
            return
        occ = np.flatnonzero(self._occ)
        # smallest touch sequences go; sequences are unique (monotone
        # counter), so the victim set is deterministic
        victims = occ[np.argpartition(self._seq[occ], over - 1)[:over]]
        for r in victims:
            key = self._keys[int(r)]
            self._row.pop(key)
            self._keys[int(r)] = None
            self._occ[r] = False
            self._free.append(int(r))


class ReuseTracker:
    """Ghost cache + per-class sketch. `hist` is a float32 [max_classes,
    n_buckets] tensor on `device` (CUDA unless the caller names another;
    without CUDA and without a device this raises)."""

    def __init__(self, n_buckets: int = 32, tau0: float = 1e-3,
                 decay: float = 0.995, ghost_capacity: int = 1 << 16,
                 max_classes: int = 8,
                 device: Optional[Union[str, torch.device]] = None):
        if n_buckets < 2 or tau0 <= 0 or not 0.0 < decay <= 1.0:
            raise ValueError("invalid sketch parameters")
        self.n_buckets = n_buckets
        self.tau0 = float(tau0)
        self.decay = float(decay)
        self.ghost_capacity = int(ghost_capacity)
        self.max_classes = int(max_classes)
        self.device = resolve_device(device)
        self.hist = torch.zeros((max_classes, n_buckets),
                                dtype=torch.float32, device=self.device)
        self._class_ids: Dict[str, int] = {}
        # array-backed ghost; keeps the `_last_seen` name (and len())
        # the tests and tooling observe
        self._last_seen = _ArrayGhost(self.ghost_capacity)
        self.observed = 0           # accesses fed in
        self.measured = 0           # of those, with a measured interval

    # ------------------------------------------------------------- classes
    def class_id(self, cls: str) -> int:
        cid = self._class_ids.get(cls)
        if cid is None:
            if len(self._class_ids) >= self.max_classes:
                raise ValueError(
                    f"more than {self.max_classes} key classes; raise "
                    f"max_classes")
            cid = len(self._class_ids)
            self._class_ids[cls] = cid
        return cid

    @property
    def classes(self) -> List[str]:
        return list(self._class_ids)

    # ------------------------------------------------------------ tracking
    def _touch(self, key, now: float) -> float:
        """Update the ghost; returns the measured interval (<= 0 when the
        key is new to the ghost)."""
        return float(self._last_seen.touch_batch([key], now)[0])

    def observe(self, key, cls: str, now: float) -> Optional[float]:
        """Single-key path; returns the measured interval or None."""
        iv = self.observe_batch([key], [cls], now)
        return iv[0] if iv[0] > 0 else None

    def observe_batch(self, keys: Sequence[object], classes: Sequence[str],
                      now: float) -> np.ndarray:
        """Feed one step's accesses; returns the measured intervals
        (<= 0 where the key was a first touch). The ghost update is one
        vectorized `touch_batch`, and the sketch sees one update on the
        tracker's device — the kernel on CUDA, the plain version on the
        CPU, bit-identical to each other.
        `classes` may be a single string applied to the whole batch, or
        a precomputed int array of `class_id` values (the zero-Python
        path for large control planes)."""
        n = len(keys)
        if isinstance(classes, str):
            cids = np.full(n, self.class_id(classes), np.int32)
        elif (isinstance(classes, np.ndarray)
                and classes.dtype.kind in "iu"):
            cids = classes.astype(np.int32)
        else:
            cids = np.fromiter((self.class_id(c) for c in classes),
                               np.int32, count=n)
        intervals = self._last_seen.touch_batch(keys, now)
        self.observed += n
        self.measured += int((intervals > 0).sum())
        self.hist = reuse_sketch_update(
            self.hist, torch.from_numpy(intervals).to(self.device),
            torch.from_numpy(cids).to(self.device), tau0=self.tau0,
            decay=self.decay)
        return intervals

    def last_seen(self, key) -> Optional[float]:
        return self._last_seen.get(key)

    def forget_keys(self, keys: Sequence[object]) -> None:
        """Purge ghost entries for keys that no longer exist anywhere
        (deleted, or lost to an unplanned host failure). Without this a
        key re-created after loss measures a spurious "reuse interval"
        against its dead predecessor's last touch and the gate admits it
        on evidence about an object that is gone. Class sketch mass is
        untouched — measured history of the *class* remains valid."""
        for key in keys:
            self._last_seen.discard(key)

    def seed_prior(self, cls: str, interval: float, weight: float = 1.0):
        """Declared workload prior: add `weight` mass at `interval` to
        the class sketch directly (no synthetic ghost entries) — how
        `HierarchySpec.class_priors` pre-loads first-touch admission
        before any reuse has been measured. Decays away like measured
        mass, so real telemetry supersedes the declaration."""
        if interval <= 0:
            raise ValueError(f"prior interval must be positive seconds "
                             f"(got {interval!r})")
        if weight <= 0:
            raise ValueError("prior weight must be positive")
        cid = self.class_id(cls)
        b = int(np.clip(np.floor(np.log2(interval / self.tau0)), 0,
                        self.n_buckets - 1))
        # a float32 add, as numpy's into its float32 array
        self.hist[cid, b] += np.float32(weight).item()

    # ----------------------------------------------------------- estimates
    def _row(self, cid: int) -> np.ndarray:
        """One class row of the sketch on the host (float32 numpy), so the
        estimates below run the reference's numpy code on the same bits."""
        return self.hist[cid].cpu().numpy()

    def bucket_centers(self) -> np.ndarray:
        """Geometric center of each bucket (seconds)."""
        return self.tau0 * np.exp2(np.arange(self.n_buckets) + 0.5)

    def class_mass(self, cls: str) -> float:
        cid = self._class_ids.get(cls)
        return float(self._row(cid).sum()) if cid is not None else 0.0

    def class_quantile(self, cls: str, q: float = 0.5) -> Optional[float]:
        """Interval at cumulative mass `q` of the class's decayed
        histogram (bucket-center resolution); None when the class has
        (essentially) no measured mass yet."""
        cid = self._class_ids.get(cls)
        if cid is None:
            return None
        row = self._row(cid)
        total = float(row.sum())
        if total < 1e-6:
            return None
        cum = np.cumsum(row)
        b = int(np.searchsorted(cum, q * total, side="left"))
        return float(self.bucket_centers()[min(b, self.n_buckets - 1)])

    def interval_samples(self, cls: str,
                         max_samples: int = 512) -> np.ndarray:
        """Expand the class histogram into a representative interval
        sample (bucket centers repeated by normalized weight) — the
        input `core.workload.EmpiricalWorkload` takes. Deterministic."""
        cid = self._class_ids.get(cls)
        if cid is None:
            return np.zeros(0)
        row = self._row(cid)
        total = float(row.sum())
        if total < 1e-6:
            return np.zeros(0)
        reps = np.round(row / total * max_samples).astype(int)
        centers = self.bucket_centers()
        out = np.repeat(centers, reps)
        if out.size == 0:                       # all mass in tiny slivers
            out = centers[np.argmax(row)][None]
        return out

    def histogram(self, cls: str) -> Optional[np.ndarray]:
        cid = self._class_ids.get(cls)
        return None if cid is None else self._row(cid).copy()
