"""TieringPolicy — the actionable output of the paper, packaged for the
runtime (RQ4).

The analytics produce a break-even interval tau_be between adjacent tiers.
The runtime (serving KV cache, MoE expert store, checkpoint manager) feeds
observed reuse intervals; the policy answers "which tier should this object
live in right now". Decisions use an EMA of observed inter-access times and
a hysteresis band to avoid thrash at the boundary.

Tiers: HBM (accelerator), DRAM (host), FLASH (Storage-Next SSD). The
HBM<->DRAM boundary uses the same Eq. 1 with HBM standing in as the
"memory" and DRAM+interconnect as the "storage"; the DRAM<->FLASH boundary
is the paper's headline threshold.

Clock contract: `observe` / `evict_candidates` take an explicit `now`.
Callers on the async runtime (TieredStore and friends) always pass their
injected clock's time so decisions are deterministic under test; the
`time.monotonic()` default is a convenience edge for ad-hoc use only.
"""
from __future__ import annotations

import dataclasses
import enum
import time
from typing import Dict, Optional

import torch

from .constraints import LatencyTargets, rho_max_for_targets, usable_iops
from .economics import HostConfig, break_even
from .platform import PlatformConfig
from .ssd_model import iops_ssd_peak


class Tier(enum.IntEnum):
    """Placement tiers, ordered coldward.

    The first three are the classic per-host hierarchy. ``GPU_FLASH``
    is the BaM-style accelerator-direct flash path (same NAND, its own
    submission queue, no host-DRAM bounce — a *path*, not a medium) and
    ``POOL`` is the fleet-shared far-memory pool. Stores that predate
    the fourth tier iterate their own configured spec keys, never
    ``for t in Tier``, so adding members here does not change their
    behavior."""
    HBM = 0
    DRAM = 1
    FLASH = 2
    GPU_FLASH = 3
    POOL = 4


@dataclasses.dataclass
class TieringPolicy:
    """Two-boundary placement policy with hysteresis.

    tau_hot:  reuse intervals below this belong in HBM.
    tau_be:   reuse intervals below this (but >= tau_hot) belong in DRAM;
              above it, flash is cheaper (the five-second rule).
    hysteresis: multiplicative band; an object must exceed tau * (1 + h) to
              be demoted and drop below tau / (1 + h) to be promoted.
    """

    tau_hot: float
    tau_be: float
    hysteresis: float = 0.25
    ema_alpha: float = 0.2

    def __post_init__(self):
        if self.tau_hot > self.tau_be:
            raise ValueError("tau_hot must be <= tau_be")
        self._ema: Dict[object, float] = {}
        self._last_seen: Dict[object, float] = {}
        self._tier: Dict[object, Tier] = {}

    # ---- stateless decisions ------------------------------------------------
    def tier_for_interval(self, interval) -> Tier:
        if interval < self.tau_hot:
            return Tier.HBM
        if interval < self.tau_be:
            return Tier.DRAM
        return Tier.FLASH

    def tiers_for_intervals(self, intervals):
        """Vectorized decision: int8 tensor of Tier values."""
        iv = torch.as_tensor(intervals)
        out = torch.full(iv.shape, int(Tier.FLASH), dtype=torch.int8)
        out[iv < self.tau_be] = int(Tier.DRAM)
        out[iv < self.tau_hot] = int(Tier.HBM)
        return out

    # ---- stateful (EMA + hysteresis) ---------------------------------------
    def observe(self, key, now: Optional[float] = None) -> Tier:
        """Record an access to `key`; returns the (possibly new) tier."""
        now = time.monotonic() if now is None else now
        last = self._last_seen.get(key)
        self._last_seen[key] = now
        if last is not None:
            iv = max(now - last, 1e-9)
            prev = self._ema.get(key)
            self._ema[key] = (iv if prev is None
                              else (1 - self.ema_alpha) * prev
                              + self.ema_alpha * iv)
        return self.tier_of(key)

    def tier_of(self, key) -> Tier:
        ema = self._ema.get(key)
        if ema is None:                      # never re-accessed yet
            return self._tier.setdefault(key, Tier.DRAM)
        cur = self._tier.get(key, Tier.DRAM)
        want = self.tier_for_interval(ema)
        if want == cur:
            self._tier[key] = cur
            return cur
        # hysteresis: demotion needs interval above band, promotion below it
        h = 1.0 + self.hysteresis
        boundary = self.tau_hot if min(want, cur) == Tier.HBM else self.tau_be
        if want > cur and ema > boundary * h:
            cur = Tier(cur + 1)
        elif want < cur and ema < boundary / h:
            cur = Tier(cur - 1)
        self._tier[key] = cur
        return cur

    def forget_keys(self, keys) -> None:
        """Drop all state for `keys` — wired into delete and unplanned
        key-loss paths. A key wiped by a host failure must look like a
        first touch when it comes back: keeping the stale EMA/last-seen
        would price its re-admission off an interval the object never
        actually survived to exhibit."""
        for key in keys:
            self._ema.pop(key, None)
            self._last_seen.pop(key, None)
            self._tier.pop(key, None)

    def evict_candidates(self, tier: Tier, now: Optional[float] = None,
                         limit: int = 0):
        """Keys in `tier` with the stalest EMA — demotion order."""
        now = time.monotonic() if now is None else now
        keys = [k for k, t in self._tier.items() if t == tier]

        def staleness(k):
            # explicit None check: `ema or fallback` would treat a
            # legitimate 0.0 EMA (maximally hot) as "no EMA" and rank
            # the key by its idle gap — i.e. evict it first
            ema = self._ema.get(k)
            return ema if ema is not None \
                else now - self._last_seen.get(k, now)

        keys.sort(key=lambda k: -staleness(k))
        return keys[:limit] if limit else keys

    # ---- constructors --------------------------------------------------------
    @classmethod
    def from_platform(cls, platform: PlatformConfig, l_blk: int,
                      targets: LatencyTargets = LatencyTargets(),
                      gamma_rw: float = 9.0, phi_wa: float = 3.0,
                      hbm: Optional[HostConfig] = None, **kw):
        """Derive both boundaries from the calibrated analytics."""
        ssd = platform.ssd
        peak = float(iops_ssd_peak(ssd, l_blk, gamma_rw, phi_wa))
        rho = float(rho_max_for_targets(targets, ssd.n_ch, peak,
                                        ssd.nand.tau_sense))
        per_ssd = float(usable_iops(peak, rho, platform.iops_proc,
                                    platform.n_ssd))
        tau_be = float(break_even(platform.host, l_blk, ssd.cost, per_ssd))
        if hbm is None:
            # HBM "rent" vs DRAM fetch: HBM ~4x DRAM cost/byte, PCIe/NVLink
            # class fetch path modeled as a very high-IOPS low-cost device.
            tau_hot = tau_be / 50.0
        else:
            # treat DRAM as the storage tier: cost=die cost, IOPS=B/l
            dram_iops = platform.host.b_h_dram_die / l_blk
            tau_hot = float(break_even(hbm, l_blk, platform.host.alpha_h_dram,
                                       dram_iops))
        return cls(tau_hot=min(tau_hot, tau_be), tau_be=tau_be, **kw)
