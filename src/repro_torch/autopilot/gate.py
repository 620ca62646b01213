"""EconomicGate — break-even admission/demotion for the tiered runtime.

`core.policy.TieringPolicy` already moves *resident* objects by their
EMA'd reuse interval vs the calibrated thresholds. What it cannot do is
place an object it has never re-observed: the seed runtime admitted
everything to DRAM and let capacity pressure sort it out (LRU-ish), so
one scan flood evicts the economically-hot set and every cold write
pays DRAM rent until eviction.

The gate closes that loop with the paper's own threshold. On every
`put`/`ingest` the store asks `admit_tier(key, requested, now)`:

  * a key with an EMA (re-observed while resident) follows the
    inherited hysteresis logic — no behavior change;
  * a key the ghost cache remembers (evicted, came back) is priced by
    its *measured* time-since-last-touch;
  * a first-touch key is priced by its class's decayed sketch quantile
    (KV sessions, MoE experts, per-tenant streams learn separate
    priors), and with no class evidence defaults cold — DRAM residency
    is earned by demonstrated reuse below tau_be, never granted.

Admission to DRAM happens iff the estimate sits below the break-even
interval `tau_be` (Eq. 1, via `economics.break_even_for_ssd`); the
inherited multiplicative hysteresis band keeps boundary keys from
oscillating between admit and demote. HBM residency stays earned-only
(EMA below tau_hot), never granted at admission.

Construct with explicit thresholds, or `EconomicGate.from_break_even`
(host + SSD configs -> tau_be) / `from_platform` (feasibility-capped
IOPS, inherited). The same gate instance (or a per-host factory) plugs
into `TieredStore`, `ShardedTieredStore` and `DecodeEngine` unchanged —
they speak TieringPolicy. Its default `ReuseTracker` keeps its sketch on
`device` (CUDA unless the caller names another).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Union

import numpy as np
import torch

from ..core.economics import HostConfig, break_even_for_ssd
from ..core.policy import Tier, TieringPolicy
from ..core.ssd_model import SsdConfig
from .reuse import ReuseTracker


def default_classify(key) -> str:
    """Key -> class label: the runtime's tuple-key conventions map
    ("kv", rid) -> "kv", (layer, expert) int pairs -> "expert"; anything
    else shares one bucket."""
    if isinstance(key, tuple) and key:
        if isinstance(key[0], str):
            return key[0]
        if all(isinstance(x, (int, np.integer)) for x in key):
            return "expert"
    return "obj"


@dataclasses.dataclass
class GateStats:
    admits_dram: int = 0        # admitted under break-even
    admits_flash: int = 0       # priced out (or unknown, cold default)
    admits_pool: int = 0        # priced out of DRAM but under tau_pool
    admits_gpu_flash: int = 0   # cold admits routed to the BaM path
    readmits_measured: int = 0  # ghost supplied a measured interval
    prior_decisions: int = 0    # first touch priced by the class sketch
    cold_defaults: int = 0      # first touch with no class evidence


class EconomicGate(TieringPolicy):
    """TieringPolicy + break-even admission from tracked reuse."""

    def __init__(self, tau_hot: float, tau_be: float, *,
                 tracker: Optional[ReuseTracker] = None,
                 classify: Callable[[object], str] = default_classify,
                 prior_quantile: float = 0.5,
                 hysteresis: float = 0.25, ema_alpha: float = 0.2,
                 class_tau_be: Optional[Dict[str, float]] = None,
                 tau_pool: Optional[float] = None,
                 gpu_direct: bool = False,
                 device: Optional[Union[str, torch.device]] = None):
        super().__init__(tau_hot=tau_hot, tau_be=tau_be,
                         hysteresis=hysteresis, ema_alpha=ema_alpha)
        self.tracker = tracker or ReuseTracker(device=device)
        self.classify = classify
        self.prior_quantile = prior_quantile
        self.gate_stats = GateStats()
        # observability: attached by the fabric/platform (tracer instants
        # for every admit decision); `_priced_out` remembers keys this
        # gate sent to FLASH against a warmer ask, so the stall ledger
        # can bill their later restores to the *decision*
        # (gate_miss_restore), not the media (flash_service)
        self.obs = None
        self._priced_out = set()
        # per-class (per-tenant) break-even overrides: a class's SLO
        # alpha_stall folds into its own tau_be (see `breakeven_tau`);
        # classes not listed fall back to the fleet-wide threshold
        self.class_tau_be = dict(class_tau_be) if class_tau_be else None
        # fourth-tier thresholds. tau_pool bounds the pool band: an
        # object priced out of local DRAM (est >= tau_be) but reused
        # faster than tau_pool earns the fleet pool's discounted rent;
        # slower goes to flash. gpu_direct routes gate-cold admissions
        # to the BaM path (GPU_FLASH) — same media, no host-CPU rent.
        if tau_pool is not None and tau_pool <= tau_be:
            raise ValueError(
                "tau_pool must exceed tau_be: the pool band sits "
                "between local DRAM and flash in the reuse spectrum")
        self.tau_pool = tau_pool
        self.gpu_direct = bool(gpu_direct)

    def tau_for(self, key) -> float:
        """Break-even threshold governing `key`: its class's declared
        per-tenant tau_be when one exists, else the fleet-wide value."""
        if not self.class_tau_be:
            return self.tau_be
        return self.class_tau_be.get(self.classify(key), self.tau_be)

    # ------------------------------------------------------------ tracking
    def observe(self, key, now: Optional[float] = None) -> Tier:
        """Every runtime access (get/put) flows through here: feed the
        ghost + sketch, then the inherited EMA/hysteresis placement."""
        if now is None:
            raise ValueError("EconomicGate requires an explicit clock "
                             "time (the runtime always passes one)")
        self.tracker.observe(key, self.classify(key), now)
        return super().observe(key, now=now)

    # ----------------------------------------------------------- admission
    def _estimate(self, key, now: float):
        """Evidence cascade behind every estimate: resident EMA >
        ghost-measured gap > class sketch prior > nothing. Returns
        (estimate_or_None, source) with source in {"ema", "ghost",
        "prior", "none"} — the single place the priority order lives."""
        ema = self._ema.get(key)
        if ema is not None:
            return ema, "ema"
        last = self.tracker.last_seen(key)
        if last is not None and now > last:
            return now - last, "ghost"
        prior = self.tracker.class_quantile(self.classify(key),
                                            self.prior_quantile)
        return (prior, "prior") if prior is not None else (None, "none")

    def estimate_interval(self, key, now: float) -> Optional[float]:
        """Best reuse-interval estimate for `key` at `now`; None when no
        evidence exists at any level of the cascade."""
        return self._estimate(key, now)[0]

    def admit_tier(self, key, requested: Tier, now: float) -> Tier:
        """Landing tier for a put/ingest: DRAM iff the estimated reuse
        interval clears break-even; cold (FLASH) when nothing is known.
        Never admits straight to HBM — that residency is earned by the
        observed EMA dropping below tau_hot. Records the decision so the
        first-touch default of `tier_of` agrees with it."""
        st = self.gate_stats
        est, source = self._estimate(key, now)
        if source == "ghost":
            st.readmits_measured += 1
        elif source == "prior":
            st.prior_decisions += 1
        elif source == "none":
            st.cold_defaults += 1
        if est is not None and est < self.tau_for(key):
            decided = Tier.DRAM
            st.admits_dram += 1
        else:
            decided = Tier.FLASH
            st.admits_flash += 1
        # an explicit colder request (setup pinning data to flash) wins;
        # the gate only ever *demotes* relative to the caller's ask
        decided = Tier(max(decided, requested))
        # gate-cold admissions ride the BaM path when the host has one:
        # same flash media, but the submission engine replaces the
        # host-CPU/host-DRAM IO path (the dropped Eq. 1 rent terms). An
        # explicit FLASH pin stays FLASH — spills and restores are not
        # gate decisions.
        if (decided == Tier.FLASH and self.gpu_direct
                and requested != Tier.FLASH):
            decided = Tier.GPU_FLASH
            st.admits_gpu_flash += 1
        self._tier[key] = decided
        # priced out = the gate denied a warmer ask; a flash-pinned put
        # was never a decision and must not bill restores to the gate
        if decided == Tier.FLASH and requested < Tier.FLASH:
            self._priced_out.add(key)
        else:
            self._priced_out.discard(key)
        if self.obs is not None and self.obs.tracer is not None:
            t = self.obs.tracer
            t.instant(t.track("gate", "admit"), "admit_tier", now,
                      cat="policy",
                      args={"key": str(key),
                            "est": -1.0 if est is None else est,
                            "source": source,
                            "tau_be": self.tau_for(key),
                            "requested": requested.name,
                            "decided": decided.name})
        return decided

    def pool_admit(self, key, requested: Tier, now: float) -> bool:
        """Fleet-pool admission (the fabric asks before host placement):
        True iff the tracked estimate prices out of *local* DRAM rent
        but clears the pool column's wider tau — the band where the
        pool's discounted rent beats both DRAM rent and a flash IO.
        Cold keys (no evidence) and explicit flash pins never pool."""
        if self.tau_pool is None:
            return False
        if requested >= Tier.FLASH:
            return False
        est, _ = self._estimate(key, now)
        if est is None or est < self.tau_for(key):
            return False
        if est < self.tau_pool:
            self.gate_stats.admits_pool += 1
            return True
        return False

    def priced_out(self, key) -> bool:
        """Did this gate's last admission decision for `key` deny a
        warmer tier? (`TieredStore` asks on flash fetches — the ledger's
        gate_miss_restore attribution.)"""
        return key in self._priced_out

    def tier_of(self, key) -> Tier:
        """Resident placement under the key's *own* class threshold
        when per-class tau_be overrides exist — same EMA + hysteresis
        discipline as the inherited logic, so a premium class's wider
        tau keeps its re-observed keys in DRAM where the fleet-wide
        threshold would demote them."""
        tau_be = self.tau_for(key)
        if tau_be == self.tau_be:
            return super().tier_of(key)
        ema = self._ema.get(key)
        if ema is None:
            return self._tier.setdefault(key, Tier.DRAM)
        cur = self._tier.get(key, Tier.DRAM)
        want = Tier.HBM if ema < self.tau_hot else (
            Tier.DRAM if ema < tau_be else Tier.FLASH)
        if want == cur:
            self._tier[key] = cur
            return cur
        h = 1.0 + self.hysteresis
        boundary = self.tau_hot if min(want, cur) == Tier.HBM else tau_be
        if want > cur and ema > boundary * h:
            cur = Tier(cur + 1)
        elif want < cur and ema < boundary / h:
            cur = Tier(cur - 1)
        self._tier[key] = cur
        return cur

    def forget_keys(self, keys) -> None:
        """Key loss purges both the inherited placement state and the
        tracker's ghost entry, so a re-created key is a genuine first
        touch (priced by the class prior, not its dead predecessor)."""
        super().forget_keys(keys)
        self.tracker.forget_keys(keys)
        for key in keys:
            self._priced_out.discard(key)

    # ------------------------------------------------------------- eviction
    def evict_candidates(self, tier: Tier, now: Optional[float] = None,
                         limit: int = 0):
        """Demotion order under capacity pressure, staleness-aware: a
        key's effective interval is max(EMA, time since last touch). The
        inherited order ranks by EMA alone, so a key that was hot
        yesterday (small EMA) but has not been touched since squats in
        DRAM through a hotspot shift; the max() reclaims it first."""
        if now is None:
            raise ValueError("EconomicGate requires an explicit clock "
                             "time (the runtime always passes one)")
        keys = [k for k, t in self._tier.items() if t == tier]

        def staleness(k):
            gap = now - self._last_seen.get(k, now)
            ema = self._ema.get(k)
            return max(ema if ema is not None else 0.0, gap)

        keys.sort(key=lambda k: -staleness(k))
        return keys[:limit] if limit else keys

    # -------------------------------------------------------- constructors
    @staticmethod
    def breakeven_tau(host: HostConfig, ssd: SsdConfig, l_blk: float, *,
                      gamma_rw: float = 9.0, phi_wa: float = 3.0,
                      iops_ssd: Optional[float] = None,
                      alpha_stall: float = 0.0,
                      fetch_seconds: float = 0.0) -> float:
        """Eq. 1 tau_be with the AI-era stall correction folded in (see
        `from_break_even`). Exposed separately so per-tenant thresholds
        — one tau per declared SLO `alpha_stall` — price through the
        identical formula."""
        tau_be = float(break_even_for_ssd(host, ssd, l_blk,
                                          gamma_rw=gamma_rw,
                                          phi_wa=phi_wa,
                                          iops_ssd=iops_ssd))
        if alpha_stall and fetch_seconds:
            rent_rate = l_blk * host.alpha_h_dram / host.c_h_dram_die
            tau_be += alpha_stall * fetch_seconds / rent_rate
        return tau_be

    @classmethod
    def from_break_even(cls, host: HostConfig, ssd: SsdConfig,
                        l_blk: float, *, gamma_rw: float = 9.0,
                        phi_wa: float = 3.0,
                        iops_ssd: Optional[float] = None,
                        alpha_stall: float = 0.0,
                        fetch_seconds: float = 0.0,
                        tau_hot: Optional[float] = None, **kw):
        """Thresholds straight from the calibrated economics (Eq. 1):
        tau_be = break_even_for_ssd(host, ssd, l_blk); tau_hot defaults
        to tau_be / 50 (the HBM rent heuristic `from_platform` uses).

        The AI-era correction the paper argues for: a serving miss does
        not just consume an SSD IO, it *stalls the engine* for the fetch.
        Pass `alpha_stall` (normalized rent of the stalled serving
        resource, $/s in NAND-die units — the same units alpha_core is
        in) and `fetch_seconds` (the modeled demand-fetch time, e.g.
        `SsdQueueModel.service(l_blk, 1).total`) and the miss's stall
        cost joins Eq. 1's numerator:

            tau_be += alpha_stall * fetch_seconds / dram_rent_rate

        which widens the DRAM set exactly as much as stalled-accelerator
        time is worth."""
        tau_be = cls.breakeven_tau(host, ssd, l_blk, gamma_rw=gamma_rw,
                                   phi_wa=phi_wa, iops_ssd=iops_ssd,
                                   alpha_stall=alpha_stall,
                                   fetch_seconds=fetch_seconds)
        if tau_hot is None:
            tau_hot = tau_be / 50.0
        return cls(tau_hot=min(tau_hot, tau_be), tau_be=tau_be, **kw)
