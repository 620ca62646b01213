"""ProvisionAdvisor — live, trace-driven provisioning guidance.

`core.platform.analyze_platform` answers the paper's §V questions for an
*assumed* (log-normal) workload. The advisor answers them for the
workload the runtime actually served: it consumes the ReuseTracker's
decayed per-class interval histograms (what reuse intervals really look
like right now), the store/fabric's `TierStats` (what the tiers really
did), and any `RebalanceStats` (what elasticity really cost), and emits
the same kind of actionable output — the economically-hot working set,
the DRAM:flash split to provision, a host count, and whether the
deployment is capacity- or bandwidth-limited per `core.workload`'s
T_B/T_S/T_C thresholds.

The bridge is `EmpiricalWorkload`: each class's histogram expands into a
weighted interval sample (bucket-center resolution), samples are scaled
so classes contribute proportionally to their resident key census, and
the §V threshold machinery runs unchanged on the result.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from ..core.economics import (HostConfig, break_even_for_ssd,
                              pool_flash_crossover)
from ..core.ssd_model import SsdConfig
from ..core.workload import EmpiricalWorkload, thresholds
from ..core.policy import Tier
from .gate import default_classify
from .reuse import ReuseTracker


@dataclasses.dataclass
class ProvisionAdvice:
    tau_be: float                   # calibrated break-even (s)
    horizon: float                  # seconds of trace the stats cover
    resident_bytes: float           # unique payload across tiers
    dram_capacity: float
    dram_used: float
    hot_bytes: float                # economically-hot set |S(tau_be)|*l
    hot_fraction: float             # hot_bytes / resident_bytes
    recommended_dram_bytes: float   # provision target for DRAM
    recommended_hosts: int
    t_b: float                      # DRAM-bandwidth threshold
    t_s: float                      # SSD-bandwidth threshold
    t_c: float                      # DRAM-capacity threshold
    limit: str                      # capacity | dram-bandwidth |
    #                                 ssd-bandwidth | none
    verdict: str
    classes: Dict[str, Dict[str, float]]
    rebalance: Optional[Dict[str, float]] = None

    @property
    def bandwidth_limited(self) -> bool:
        """True when the binding constraint is a *bandwidth* threshold
        (T_B: DRAM wire, T_S: SSD lanes) rather than capacity — more
        bytes on the same hosts won't help; more hosts (more spindles
        and DRAM channels) will. `Autoscaler` folds this verdict into
        its add/remove decisions."""
        return self.limit in ("dram-bandwidth", "ssd-bandwidth")

    def as_dict(self) -> Dict[str, object]:
        d = dataclasses.asdict(self)
        return {k: v for k, v in d.items() if v is not None}

    def report(self) -> str:
        lines = [
            f"tau_be={self.tau_be:.3f}s  horizon={self.horizon:.1f}s  "
            f"resident={self.resident_bytes/2**20:.1f}MiB",
            f"hot set {self.hot_bytes/2**20:.1f}MiB "
            f"({self.hot_fraction*100:.0f}% of resident) -> provision "
            f"DRAM {self.recommended_dram_bytes/2**20:.1f}MiB "
            f"across {self.recommended_hosts} host(s) "
            f"(now: {self.dram_used/2**20:.1f}/"
            f"{self.dram_capacity/2**20:.1f}MiB)",
            f"T_B={self.t_b:.3g}s T_S={self.t_s:.3g}s T_C={self.t_c:.3g}s"
            f"  limit={self.limit}",
        ]
        for cls, row in self.classes.items():
            med = row["median_interval"]
            med_s = f"{med:.3f}s" if med == med else "unmeasured"
            lines.append(
                f"  class {cls:12s} keys={int(row['keys']):5d} "
                f"median={med_s:>10s} hot={row['hot_fraction']*100:5.1f}%")
        if self.rebalance:
            lines.append(
                f"  rebalance: {int(self.rebalance['events'])} event(s), "
                f"{self.rebalance['bytes_moved']/2**20:.1f}MiB moved "
                f"({self.rebalance['moved_fraction']*100:.1f}% of "
                f"resident)")
        lines.append(f"VERDICT: {self.verdict}")
        return "\n".join(lines)


@dataclasses.dataclass
class AvailabilityAdvice:
    """Replication-factor recommendation: availability priced in $/s.

    `arms` maps each candidate replication factor r to its modeled
    cost-rate breakdown (NAND-die-normalized $ per second, the same
    units every cost-reporting bench uses):

      * rent   — extra DRAM byte-seconds for the r-1 replica copies
      * write  — extra wire + flash-page cost for streaming r-1 copies
                 on every put
      * repair — expected re-replication traffic after failures
                 (failure rate x bytes to re-stream per failure)
      * loss   — expected failure stall: with r=1 the dead host's
                 resident bytes are *gone* and must be recomputed /
                 re-ingested while the serving resource stalls;
                 replication converts this to a degraded read
    """
    mttf: float                     # per-host mean time to failure (s)
    failure_rate: float             # expected host failures / s (fleet)
    resident_bytes: float
    n_hosts: int
    recommended_replicas: int
    arms: Dict[int, Dict[str, float]]
    verdict: str

    def as_dict(self) -> Dict[str, object]:
        d = dataclasses.asdict(self)
        # JSON object keys are strings; keep the emitted dict stable
        d["arms"] = {str(r): row for r, row in sorted(self.arms.items())}
        return d

    def report(self) -> str:
        lines = [f"mttf={self.mttf:.0f}s/host  "
                 f"fleet failure rate={self.failure_rate:.2e}/s  "
                 f"resident={self.resident_bytes/2**20:.1f}MiB "
                 f"on {self.n_hosts} host(s)"]
        for r, row in sorted(self.arms.items()):
            tag = " <- recommended" if r == self.recommended_replicas \
                else ""
            lines.append(
                f"  r={r}: total={row['total']:.3e}/s  "
                f"(rent={row['rent']:.2e} write={row['write']:.2e} "
                f"repair={row['repair']:.2e} loss={row['loss']:.2e})"
                f"{tag}")
        lines.append(f"VERDICT: {self.verdict}")
        return "\n".join(lines)


@dataclasses.dataclass
class TierAdvice:
    """Fourth-tier recommendation: which hierarchy shape to deploy.

    `arms` maps each candidate shape to its modeled miss-path cost rate
    (NAND-die-normalized $ per second — DRAM rent for the locally-hot
    set is identical across arms and omitted):

      * baseline  — 3 tiers; every DRAM miss is a host-CPU flash IO
      * gpu_flash — misses ride the BaM submission engine (no host-CPU
                    or host-DRAM-wire rent, deeper device queue)
      * pool      — the pool band (tau_be <= interval < tau_pool) moves
                    to the fleet pool at discounted rent + an RTT lane;
                    the rest stays on the host flash path
      * both      — pool band pooled, residual misses gpu-direct

    Each row: io (wire + media + host/submit $), pool_rent (discounted
    DRAM-class rent on pooled bytes), stall (alpha_stall x modeled
    stall seconds), total, and stall_seconds (unpriced, per second of
    serving — the bench's equal-or-lower-stall check reads this).
    """
    tau_be: float
    tau_pool: float
    access_rate: float
    resident_bytes: float
    miss_fraction: float            # accesses priced out of local DRAM
    pool_band_fraction: float       # fraction of *misses* in the band
    arms: Dict[str, Dict[str, float]]
    recommended_arm: str
    verdict: str

    def as_dict(self) -> Dict[str, object]:
        return dataclasses.asdict(self)

    def report(self) -> str:
        lines = [f"tau_be={self.tau_be:.3f}s  tau_pool={self.tau_pool:.3f}s"
                 f"  miss={self.miss_fraction*100:.1f}%  "
                 f"pool band={self.pool_band_fraction*100:.1f}% of misses"]
        for arm in ("baseline", "gpu_flash", "pool", "both"):
            row = self.arms[arm]
            tag = " <- recommended" if arm == self.recommended_arm else ""
            lines.append(
                f"  {arm:9s}: total={row['total']:.3e}/s  "
                f"(io={row['io']:.2e} rent={row['pool_rent']:.2e} "
                f"stall={row['stall']:.2e}; "
                f"{row['stall_seconds']*1e3:.3f}ms stall/s){tag}")
        lines.append(f"VERDICT: {self.verdict}")
        return "\n".join(lines)


class ProvisionAdvisor:
    def __init__(self, host: HostConfig, ssd: SsdConfig, l_blk: float, *,
                 gamma_rw: float = 9.0, phi_wa: float = 3.0,
                 dram_bytes_per_host: Optional[float] = None,
                 headroom: float = 1.25, classify=default_classify,
                 active_window: Optional[float] = None):
        self.host = host
        self.ssd = ssd
        self.l_blk = float(l_blk)
        self.gamma_rw = gamma_rw
        self.phi_wa = phi_wa
        self.dram_bytes_per_host = dram_bytes_per_host
        self.headroom = headroom        # provision above the hot set
        self.classify = classify
        # staleness horizon for the hot set: a resident key untouched
        # for longer than this (per the tracker's ghost) is excluded
        # from the hot-byte census — without it, yesterday's pool keeps
        # the recommendation pinned at peak after a diurnal shift,
        # because the interval *distribution* stays hot while the keys
        # carrying it go cold. None keeps the census-wide behavior.
        if active_window is not None and active_window <= 0:
            raise ValueError("active_window must be positive seconds")
        self.active_window = active_window
        self.tau_be = float(break_even_for_ssd(
            host, ssd, l_blk, gamma_rw=gamma_rw, phi_wa=phi_wa))

    # ----------------------------------------------------------------- util
    def _census(self, stores, tracker: Optional[ReuseTracker] = None,
                now: Optional[float] = None
                ) -> Dict[str, Dict[str, float]]:
        """Per-class resident key/byte counts (one copy per key).
        `active_bytes` restricts to keys touched within `active_window`
        of `now` (per the tracker's ghost); with no window every
        resident byte is active."""
        seen: Dict[object, int] = {}
        for store in stores:
            for key in store.keys():
                if key not in seen:
                    seen[key] = store.nbytes_of(key)
        census: Dict[str, Dict[str, float]] = {}
        for key, nbytes in seen.items():
            row = census.setdefault(self.classify(key),
                                    {"keys": 0.0, "bytes": 0.0,
                                     "active_bytes": 0.0})
            row["keys"] += 1
            row["bytes"] += nbytes
            active = True
            if (self.active_window is not None and tracker is not None
                    and now is not None):
                last = tracker.last_seen(key)
                active = (last is not None
                          and now - last <= self.active_window)
            if active:
                row["active_bytes"] += nbytes
        return census

    # ----------------------------------------------------------------- main
    def advise(self, tracker: ReuseTracker, store=None, fabric=None,
               horizon: Optional[float] = None) -> ProvisionAdvice:
        """Guidance from live state: pass a single `TieredStore` or a
        `ShardedTieredStore` fabric (its per-host stores aggregate)."""
        if (store is None) == (fabric is None):
            raise ValueError("pass exactly one of store= or fabric=")
        stores = [store] if store is not None else \
            list(fabric.hosts.values())
        clock = stores[0].clock
        horizon = clock.now() if horizon is None else float(horizon)

        census = self._census(stores, tracker=tracker, now=horizon)
        resident = sum(row["bytes"] for row in census.values())
        dram_cap = sum(s.specs[Tier.DRAM].capacity_bytes for s in stores)
        dram_used = sum(s.used_bytes(Tier.DRAM) for s in stores)

        # per-class hot fractions + a census-weighted combined workload
        classes: Dict[str, Dict[str, float]] = {}
        samples: List[np.ndarray] = []
        for cls, row in sorted(census.items()):
            sample = tracker.interval_samples(cls, max_samples=256)
            if sample.size:
                wl = EmpiricalWorkload(sample, l_blk=self.l_blk,
                                       n_blk=row["keys"])
                hot = float(wl.cached_block_fraction(self.tau_be))
                median = float(np.median(sample))
                # class contributes samples proportional to its keys
                reps = max(1, int(round(row["keys"])))
                idx = (np.arange(reps) * sample.size // reps)
                samples.append(sample[idx % sample.size])
            else:
                # no measured reuse: economically cold by default
                hot, median = 0.0, float("nan")
                samples.append(np.full(max(1, int(row["keys"])),
                                       self.tau_be * 64.0))
            classes[cls] = {"keys": row["keys"], "bytes": row["bytes"],
                            "median_interval": median,
                            "hot_fraction": hot}
            if self.active_window is not None:
                classes[cls]["active_bytes"] = row["active_bytes"]

        # hot bytes scale the *active* census when a staleness window is
        # set (keys untouched past it are squatters, not hot set)
        hot_bytes = sum(
            census[cls]["active_bytes" if self.active_window is not None
                        else "bytes"] * row["hot_fraction"]
            for cls, row in classes.items())
        target = hot_bytes * self.headroom

        if samples:
            combined = EmpiricalWorkload(
                np.concatenate(samples), l_blk=self.l_blk,
                n_blk=sum(r["keys"] for r in census.values()))
            b_dram = sum(s.specs[Tier.DRAM].read_bw for s in stores)
            b_ssd = sum(s.specs[Tier.FLASH].read_bw for s in stores)
            th = thresholds(combined, b_dram, b_ssd, c_dram=dram_cap)
            t_b, t_s, t_c = th.t_b, th.t_s, th.t_c
            if not th.viable:
                limit = "capacity" if t_c < th.t_v else "none"
            elif t_b >= t_s and t_b > self.tau_be:
                limit = "dram-bandwidth"
            elif t_s > t_b and t_s > self.tau_be:
                limit = "ssd-bandwidth"
            elif self.tau_be > t_c:
                limit = "capacity"
            else:
                limit = "none"
        else:
            t_b = t_s = t_c = float("nan")
            limit = "none"

        per_host = self.dram_bytes_per_host or (dram_cap /
                                                max(len(stores), 1))
        hosts = max(1, int(np.ceil(target / max(per_host, 1.0))))

        rebalance = None
        if fabric is not None and fabric.rebalances:
            moved = float(sum(rb.bytes_moved for rb in fabric.rebalances))
            rebalance = {
                "events": float(len(fabric.rebalances)),
                "bytes_moved": moved,
                "moved_fraction": moved / max(resident, 1.0),
            }

        verdict = self._verdict(limit, target, dram_cap, hosts,
                                len(stores))
        return ProvisionAdvice(
            tau_be=self.tau_be, horizon=horizon,
            resident_bytes=float(resident), dram_capacity=float(dram_cap),
            dram_used=float(dram_used), hot_bytes=float(hot_bytes),
            hot_fraction=float(hot_bytes / max(resident, 1.0)),
            recommended_dram_bytes=float(target),
            recommended_hosts=hosts, t_b=float(t_b), t_s=float(t_s),
            t_c=float(t_c), limit=limit, verdict=verdict,
            classes=classes, rebalance=rebalance)

    # ------------------------------------------------------- availability
    def advise_availability(self, *, fabric=None,
                            resident_bytes: Optional[float] = None,
                            n_hosts: Optional[int] = None,
                            dram_fraction: Optional[float] = None,
                            mttf: float,
                            alpha_stall: float = 4.0,
                            recompute_seconds: float = 1.0,
                            put_bytes_per_second: float = 0.0,
                            max_replicas: int = 3) -> AvailabilityAdvice:
        """Recommend a replication factor the way `advise` recommends a
        DRAM:flash split: price each candidate r and pick the cheapest.

        The availability version of Eq. 1's tradeoff — replication
        *rent* (extra DRAM byte-seconds for the copies, extra wire +
        flash-page writes on every put, expected repair traffic after
        failures) against the expected *failure stall* of running
        unreplicated: a lost object's only copy is gone, so the serving
        resource (priced at `alpha_stall`, the same normalized rent the
        AI-era Eq. 1 correction uses) stalls `recompute_seconds` per
        object to regenerate it — a decode recompute, not an SSD
        re-read, which is exactly why the loss term dwarfs the IO rates
        at serving-scale MTTFs. With a long MTTF the loss term vanishes
        and r=1 wins; as MTTF shrinks the expected stall crosses the
        copy rent and the recommendation steps up — the bench's
        kill-at-peak scenario checks the recommendation against
        measured $/token.

        Pass `fabric=` to census live state, or the explicit scalars."""
        if mttf <= 0:
            raise ValueError("mttf must be positive seconds per host")
        if max_replicas < 1:
            raise ValueError("max_replicas must be >= 1")
        if fabric is not None:
            stores = list(fabric.hosts.values())
            seen: Dict[object, int] = {}
            for s in stores:
                for key in s.keys():
                    seen.setdefault(key, s.nbytes_of(key))
            if resident_bytes is None:
                resident_bytes = float(sum(seen.values()))
            if n_hosts is None:
                n_hosts = fabric.n_hosts
            if dram_fraction is None:
                used = sum(s.used_bytes(Tier.DRAM)
                           + s.used_bytes(Tier.FLASH) for s in stores)
                dram = sum(s.used_bytes(Tier.DRAM) for s in stores)
                dram_fraction = dram / used if used > 0 else 0.0
        if resident_bytes is None or n_hosts is None:
            raise ValueError(
                "pass fabric= or both resident_bytes= and n_hosts=")
        if dram_fraction is None:
            dram_fraction = 0.0
        n_hosts = int(n_hosts)
        if n_hosts < 1:
            raise ValueError("n_hosts must be >= 1")

        # lazy: bench.py imports this module at load time
        from .bench import PAGE_BYTES, pricing_rates
        rates = pricing_rates(self.host, self.ssd)
        lam = n_hosts / mttf            # fleet-wide failures per second
        share = resident_bytes / n_hosts    # bytes lost with one host
        page_rate = rates["page_io_cost"] / PAGE_BYTES  # $ per byte of IO
        wire = rates["dram_wire_rate"]

        arms: Dict[int, Dict[str, float]] = {}
        # a copy set cannot exceed the fleet; candidate arms above
        # n_hosts would silently price the same placement
        r_max = min(max_replicas, n_hosts)
        for r in range(1, r_max + 1):
            rent = (r - 1) * resident_bytes * dram_fraction \
                * rates["rent_rate"]
            write = (r - 1) * put_bytes_per_second * (wire + page_rate)
            if r >= 2:
                # a failure re-streams the dead host's share; the ring
                # shrink also re-targets surviving copy sets, so repair
                # traffic scales with the total copies the host touched
                repair = lam * (r * share) * (wire + 2.0 * page_rate)
                loss = 0.0
            else:
                repair = 0.0
                # sole copies gone: the serving resource stalls
                # `recompute_seconds` per lost object to regenerate the
                # dead host's resident share (share/l_blk objects)
                loss = lam * (share / self.l_blk) \
                    * recompute_seconds * alpha_stall
            arms[r] = {"rent": float(rent), "write": float(write),
                       "repair": float(repair), "loss": float(loss),
                       "total": float(rent + write + repair + loss)}

        recommended = min(sorted(arms),
                          key=lambda r: (arms[r]["total"], r))
        if recommended == 1:
            verdict = ("run unreplicated: at this MTTF the expected "
                       "failure stall is cheaper than copy rent")
        else:
            verdict = (f"replicate x{recommended}: expected failure "
                       f"stall at mttf={mttf:.0f}s outprices the copy "
                       f"rent + repair traffic")
        return AvailabilityAdvice(
            mttf=float(mttf), failure_rate=float(lam),
            resident_bytes=float(resident_bytes), n_hosts=n_hosts,
            recommended_replicas=int(recommended), arms=arms,
            verdict=verdict)

    # ------------------------------------------------------------ 4th tier
    def advise_tiers(self, tracker: Optional[ReuseTracker] = None, *,
                     access_rate: float, resident_bytes: float,
                     object_bytes: Optional[float] = None,
                     interval_samples: Optional[np.ndarray] = None,
                     pool_bw: float = 40e9, pool_rtt: float = 2e-6,
                     rent_factor: float = 0.5, alpha_net: float = 2.0,
                     alpha_submit: float = 0.5, iops_submit: float = 2e7,
                     submit_latency: float = 3e-6,
                     alpha_stall: float = 4.0,
                     flash_fetch_seconds: Optional[float] = None,
                     gpu_fetch_seconds: Optional[float] = None,
                     max_samples: int = 256) -> TierAdvice:
        """Price the four hierarchy shapes (3-tier baseline, +gpu_flash,
        +pool, +both) against the measured reuse-interval distribution
        and recommend the cheapest.

        The split is Eq. 1 run per column: accesses whose tracked
        interval clears tau_be stay local-DRAM (identical across arms,
        not priced); the rest are the miss stream. Within it, intervals
        under the pool column's tau_pool earn the pool's discounted
        rent instead of a flash IO; gpu_flash reprices the *residual*
        flash IOs by dropping the host-CPU and host-DRAM-wire rent for
        a submission-engine charge. Stall seconds are priced at
        `alpha_stall` exactly like the AI-era tau_be correction.

        Pass `tracker=` for live distributions, or `interval_samples=`
        directly (the tiers bench replays its measured intervals)."""
        if access_rate < 0 or resident_bytes < 0:
            raise ValueError("rates and bytes must be non-negative")
        if (tracker is None) == (interval_samples is None):
            raise ValueError(
                "pass exactly one of tracker= or interval_samples=")
        b = float(object_bytes if object_bytes is not None else self.l_blk)
        if interval_samples is None:
            parts = [tracker.interval_samples(cls, max_samples=max_samples)
                     for cls in tracker.classes]
            parts = [p for p in parts if p.size]
            samples = (np.concatenate(parts) if parts
                       else np.empty(0))
        else:
            samples = np.asarray(interval_samples, dtype=float)

        tau_pool = float(pool_flash_crossover(
            self.host, self.l_blk, self.tau_be, pool_bw=pool_bw,
            pool_rtt=pool_rtt, rent_factor=rent_factor,
            alpha_net=alpha_net))
        if samples.size:
            miss = float(np.mean(samples >= self.tau_be))
            band = float(np.mean((samples >= self.tau_be)
                                 & (samples < tau_pool)))
        else:
            miss, band = 1.0, 0.0       # no evidence: everything cold
        p_band = band / miss if miss > 0 else 0.0

        # modeled demand-fetch times from the calibrated queue models
        # (lazy: runtime imports autopilot at package load)
        from ..runtime.service import GpuDirectQueueModel, SsdQueueModel
        ssd_q = SsdQueueModel.shared()
        if flash_fetch_seconds is None:
            flash_fetch_seconds = float(ssd_q.service(b, 1).total)
        if gpu_fetch_seconds is None:
            gpu_fetch_seconds = float(GpuDirectQueueModel(
                ssd_q, submit_latency=submit_latency).service(b, 1).total)
        pool_fetch_seconds = b / pool_bw + pool_rtt

        from .bench import PAGE_BYTES, pricing_rates
        rates = pricing_rates(self.host, self.ssd)
        page_per_byte = rates["page_io_cost"] / PAGE_BYTES
        # per-access $ on each miss path (host/submit + wire + media)
        flash_access = (rates["host_io_cost"]
                        + rates["dram_wire_rate"] * b + page_per_byte * b)
        gpu_access = alpha_submit / iops_submit + page_per_byte * b
        pool_access = alpha_net * pool_fetch_seconds
        pool_rent = (resident_bytes * band * rates["rent_rate"]
                     * rent_factor)
        miss_rate = access_rate * miss

        def _arm(residual: float, residual_fetch: float,
                 has_pool: bool) -> Dict[str, float]:
            frac = p_band if has_pool else 0.0
            io = miss_rate * ((1.0 - frac) * residual
                              + frac * pool_access)
            stall_s = miss_rate * ((1.0 - frac) * residual_fetch
                                   + frac * pool_fetch_seconds)
            rent = pool_rent if has_pool else 0.0
            stall = alpha_stall * stall_s
            return {"io": float(io), "pool_rent": float(rent),
                    "stall": float(stall), "stall_seconds": float(stall_s),
                    "total": float(io + rent + stall)}

        arms = {
            "baseline": _arm(flash_access, flash_fetch_seconds, False),
            "gpu_flash": _arm(gpu_access, gpu_fetch_seconds, False),
            "pool": _arm(flash_access, flash_fetch_seconds, True),
            "both": _arm(gpu_access, gpu_fetch_seconds, True),
        }
        order = ("baseline", "gpu_flash", "pool", "both")
        recommended = min(order, key=lambda a: (arms[a]["total"],
                                                order.index(a)))
        if recommended == "baseline":
            verdict = ("keep 3 tiers: at this reuse mix neither the BaM "
                       "path nor pooled rent beats host flash IO")
        elif recommended == "gpu_flash":
            verdict = ("add gpu_flash: host-CPU IO rent dominates the "
                       "miss stream; the submission engine removes it")
        elif recommended == "pool":
            verdict = ("add the fleet pool: the pool band's discounted "
                       "rent underprices its flash re-reads")
        else:
            verdict = ("add both: pool the reuse band, ride the BaM "
                       "path for the cold residual")
        return TierAdvice(
            tau_be=float(self.tau_be), tau_pool=tau_pool,
            access_rate=float(access_rate),
            resident_bytes=float(resident_bytes),
            miss_fraction=miss, pool_band_fraction=float(p_band),
            arms=arms, recommended_arm=recommended, verdict=verdict)

    def _verdict(self, limit: str, target: float, dram_cap: float,
                 hosts: int, cur_hosts: int) -> str:
        if limit == "capacity":
            return ("capacity-limited: the measured hot set does not fit "
                    "DRAM; add DRAM or hosts before faster devices")
        if limit == "dram-bandwidth":
            return ("dram-bandwidth-limited: the miss path saturates "
                    "DRAM before capacity matters; faster memory, not "
                    "more of it")
        if limit == "ssd-bandwidth":
            return ("ssd-bandwidth-limited: the uncached stream exceeds "
                    "flash throughput; add SSDs or spread shards wider")
        if target > dram_cap:
            return (f"provision up: grow DRAM to the measured hot set "
                    f"({hosts} host(s) at current per-host capacity)")
        if hosts < cur_hosts:
            return (f"provision down: the measured hot set fits "
                    f"{hosts} host(s); the fleet is over-provisioned")
        return ("operate at tau_be: current provisioning matches the "
                "measured hot set")
