"""Closed provisioning loop: the advisor drives the fleet.

`ProvisionAdvisor` answers the paper's §V questions from live
telemetry but only *advises*. `Autoscaler` closes the loop:
`Platform.autoscale(step)` compares the advisor's measured-hot-set host
recommendation against the current fleet and calls the elastic fabric's
`add_host`/`remove_host` under the spec's bounds (`AutoscaleDecl`:
min/max hosts, cooldown) and rebalance pacer (`rebalance_rate` token
bucket) — the diurnal fleet grows a host for the peak and hands it back
off-peak, paying only the measured rebalance tax.

`run_autoscale_bench` prices the loop on a scenario trace: modeled
$/token (DRAM rent on *provisioned* capacity — provisioning is the
knob — plus flash IO, host CPU and stalled-engine time) for the
autoscaled fleet vs a static fleet provisioned for the peak. The
acceptance bound (asserted in tests, reported by
`python -m repro_torch.benchmarks.serving_autopilot --autoscale`): the
loop ends within one host of the advisor's final recommendation at
equal-or-lower $/token than the static fleet.

Every host's economic gate feeds the platform's one fleet-wide
`ReuseTracker`, whose sketch lives on `device` (the reuse_sketch kernel
on CUDA, its plain version on the CPU): the record does not depend on
it, and matches the reference package's byte for byte.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from ..autopilot.bench import PAGE_BYTES, pricing_rates
from ..autopilot.traces import generate
from ..core.policy import Tier
from .spec import AutoscaleDecl, HierarchySpec, HostDecl, PolicyDecl, \
    TierDecl


@dataclasses.dataclass
class AutoscaleDecision:
    """One closed-loop step: what the advisor saw, what the loop did."""
    step: int
    action: str                 # "add" | "remove" | "hold"
    n_hosts: int                # fleet size after the action
    recommended: int            # advisor's clamped host count
    reason: str
    rebalance: Optional[Dict[str, float]] = None

    def as_dict(self) -> Dict[str, object]:
        d = dataclasses.asdict(self)
        return {k: v for k, v in d.items() if v is not None}


class Autoscaler:
    """Advisor-driven elastic control for a compiled `Platform`."""

    def __init__(self, platform):
        self.platform = platform
        self.decl: AutoscaleDecl = platform.spec.autoscale
        self.decisions: List[AutoscaleDecision] = []
        self._last_change: Optional[int] = None
        self._auto_step = 0

    def step(self, step: Optional[int] = None) -> AutoscaleDecision:
        """Consult the advisor once and act at most once.

        Decisions are denominated in DRAM *bytes*, not host counts: the
        advisor's `recommended_hosts` assumes template-sized hosts, so
        on a heterogeneous fleet matching the count could strand the
        hot set below its capacity target. The loop instead grows while
        the fleet's DRAM capacity is short of the advisor's provision
        target, and retires the newest host only when the survivors
        still cover it."""
        if step is None:
            step = self._auto_step
        self._auto_step = step + 1
        fabric = self.platform.fabric
        advice = self.platform.advise()
        rec = int(np.clip(advice.recommended_hosts, self.decl.min_hosts,
                          self.decl.max_hosts))
        target = advice.recommended_dram_bytes
        cur = fabric.n_hosts

        def dram_cap(h):
            return fabric.hosts[h].specs[Tier.DRAM].capacity_bytes

        cap = sum(dram_cap(h) for h in fabric.host_ids)
        victim = max(fabric.host_ids)           # the newest host
        if (self._last_change is not None
                and step - self._last_change < self.decl.cooldown_steps):
            d = AutoscaleDecision(step, "hold", cur, rec,
                                  f"cooldown ({step - self._last_change}"
                                  f"/{self.decl.cooldown_steps} steps "
                                  f"since last change)")
        elif cap < target and cur < self.decl.max_hosts:
            rb = self.platform.add_host()
            self._last_change = step
            d = AutoscaleDecision(step, "add", fabric.n_hosts, rec,
                                  f"hot-set target {target/2**20:.1f}MiB "
                                  f"exceeds fleet DRAM "
                                  f"{cap/2**20:.1f}MiB",
                                  rebalance=rb.as_dict())
        elif advice.bandwidth_limited and cur < self.decl.max_hosts:
            # capacity covers the hot set but the binding constraint is
            # a bandwidth threshold (T_B: DRAM wire, T_S: SSD lanes) —
            # more bytes on the same hosts won't help; more hosts
            # (spindles + DRAM channels) spread the demand
            rb = self.platform.add_host()
            self._last_change = step
            d = AutoscaleDecision(step, "add", fabric.n_hosts, rec,
                                  f"{advice.limit}-limited "
                                  f"(T_B={advice.t_b:.3g}s "
                                  f"T_S={advice.t_s:.3g}s): adding a "
                                  f"host to spread bandwidth demand",
                                  rebalance=rb.as_dict())
        elif (cur > self.decl.min_hosts
                and cap - dram_cap(victim) >= target
                and not advice.bandwidth_limited):
            rb = fabric.remove_host(victim)
            self._last_change = step
            d = AutoscaleDecision(step, "remove", fabric.n_hosts, rec,
                                  f"hot-set target {target/2**20:.1f}MiB "
                                  f"fits without host {victim}; "
                                  f"retiring it",
                                  rebalance=rb.as_dict())
        else:
            d = AutoscaleDecision(step, "hold", cur, rec,
                                  "fleet capacity matches the target"
                                  if not advice.bandwidth_limited else
                                  f"{advice.limit}-limited but at "
                                  f"max_hosts={self.decl.max_hosts}; "
                                  f"holding")
        self.decisions.append(d)
        return d


# ---------------------------------------------------------------------------
# The autoscale benchmark (diurnal trace, closed loop vs static fleet)
# ---------------------------------------------------------------------------

def default_autoscale_spec(l_blk: int = 128 << 10, *,
                           alpha_stall: float = 4.0,
                           dram_blocks_per_host: int = 20,
                           max_hosts: int = 4,
                           active_window: float = 4.0,
                           cooldown_steps: int = 20,
                           rebalance_rate: Optional[float] = 2e9
                           ) -> HierarchySpec:
    """A one-host seed fleet sized so one trace pool's hot set fits a
    single host and the diurnal overlap needs two — the shape the
    closed-loop acceptance criterion exercises."""
    host = HostDecl(tiers={
        "hbm": TierDecl(2 * l_blk, 819e9, 1e-7),
        "dram": TierDecl(dram_blocks_per_host * l_blk, 45e9, 5e-7),
        "flash": TierDecl(1 << 34, 7e9, 2e-5),
    })
    return HierarchySpec(
        hosts=(host,),
        policy=PolicyDecl.economic(l_blk=l_blk, alpha_stall=alpha_stall),
        rebalance_rate=rebalance_rate,
        autoscale=AutoscaleDecl(min_hosts=1, max_hosts=max_hosts,
                                cooldown_steps=cooldown_steps,
                                active_window=active_window))


def _run_arm(spec: HierarchySpec, trace, *, l_blk: int, step_time: float,
             tokens_per_step: int, alpha_accel: float, every: int,
             autoscale: bool, sim_cfg=None,
             device: Optional[Union[str, torch.device]] = None
             ) -> Dict[str, object]:
    from .compiler import Platform
    platform = Platform.compile(spec, sim_cfg=sim_cfg, device=device)
    fabric, clock = platform.fabric, platform.clock
    host_cfg, ssd = spec.policy.economics()
    blob = np.zeros(max(l_blk // 4, 1), np.float32)

    total_stall = 0.0
    first_touches = 0
    provisioned_byte_seconds = 0.0
    host_seconds = 0.0
    peak_hosts = fabric.n_hosts
    last_t = clock.now()
    for t, step in enumerate(trace.steps):
        for key in step:
            h = fabric.owner(key)
            if fabric.tier_of(key) is None:
                # the ask is DRAM; the per-host gate re-tiers it by the
                # tracked reuse estimate vs break-even
                fabric.put(key, blob, tier=Tier.DRAM, from_host=h)
                first_touches += 1
            else:
                t0 = clock.now()
                fabric.get(key, from_host=h)
                total_stall += clock.now() - t0
        clock.advance(step_time)
        now = clock.now()
        dt = now - last_t
        for store in fabric.hosts.values():
            provisioned_byte_seconds += \
                store.specs[Tier.DRAM].capacity_bytes * dt
        host_seconds += fabric.n_hosts * dt
        last_t = now
        if autoscale and (t + 1) % every == 0:
            platform.autoscale(t)
            peak_hosts = max(peak_hosts, fabric.n_hosts)
    horizon = clock.now()
    platform.drain()

    # -------------------------------------------------------- cost model
    # the same normalized rates as the admission benchmark
    # (autopilot.bench.pricing_rates), with rent charged on
    # *provisioned* capacity — provisioning is this loop's knob
    rates = pricing_rates(host_cfg, ssd)
    flash_pages = 0
    dram_bytes_moved = 0
    total_ios = 0
    for store in fabric._all_stores():
        q = store.runtime.qstats
        flash_pages += -(-q[Tier.FLASH].bytes_moved // PAGE_BYTES)
        dram_bytes_moved += (q[Tier.DRAM].bytes_moved
                             + q[Tier.HBM].bytes_moved)
        total_ios += sum(s.submitted for s in q.values())
    tokens = trace.n_steps * tokens_per_step
    cost = {
        "dram_rent": provisioned_byte_seconds * rates["rent_rate"],
        "dram_wire": dram_bytes_moved * rates["dram_wire_rate"],
        "flash_io": flash_pages * rates["page_io_cost"],
        "host_cpu": total_ios * rates["host_io_cost"],
        "stall": total_stall * alpha_accel,
    }
    total_cost = float(sum(cost.values()))

    advice = platform.advise(horizon=horizon)
    out: Dict[str, object] = {
        "autoscale": bool(autoscale),
        "hosts_start": float(spec.n_hosts),
        "hosts_final": float(fabric.n_hosts),
        "hosts_peak": float(peak_hosts),
        "host_seconds": float(host_seconds),
        "horizon": float(horizon),
        "tokens": float(tokens),
        "first_touches": float(first_touches),
        "total_stall": float(total_stall),
        "per_token_stall": float(total_stall / max(tokens, 1)),
        "cost_total": total_cost,
        "cost_per_token": float(total_cost / max(tokens, 1)),
        "recommended_final": float(advice.recommended_hosts),
        "rebalances": [rb.as_dict() for rb in fabric.rebalances],
    }
    out.update({f"cost_{k}": float(v) for k, v in cost.items()})
    if autoscale and platform._autoscaler is not None:
        out["decisions"] = [d.as_dict()
                            for d in platform._autoscaler.decisions
                            if d.action != "hold"]
    return out


def run_autoscale_bench(spec: Optional[HierarchySpec] = None, *,
                        scenario: str = "diurnal",
                        n_steps: int = 240,
                        step_time: float = 0.25,
                        l_blk: int = 128 << 10,
                        tokens_per_step: int = 16,
                        alpha_accel: float = 4.0,
                        every: int = 10,
                        static_hosts: Optional[int] = None,
                        seed: int = 0,
                        sim_cfg=None,
                        device: Optional[Union[str, torch.device]] = None
                        ) -> Dict[str, object]:
    """Closed loop vs static fleet on one scenario trace.

    The autoscaled arm starts from `spec` (default: the one-host
    `default_autoscale_spec`) and lets `Platform.autoscale` act every
    `every` steps. The static arm runs the identical trace on a fixed
    fleet of `static_hosts` (default: the peak size the loop reached —
    the fleet a peak-provisioner would run all day). Deterministic:
    both arms share the seeded trace and the virtual clock. `device`
    holds the fleet tracker's sketch: CUDA unless the caller names
    the CPU."""
    spec = spec if spec is not None else default_autoscale_spec(
        l_blk, alpha_stall=alpha_accel)
    trace = generate(scenario, n_steps=n_steps, step_time=step_time,
                     seed=seed)
    kw = dict(l_blk=l_blk, step_time=step_time,
              tokens_per_step=tokens_per_step, alpha_accel=alpha_accel,
              every=every, sim_cfg=sim_cfg, device=device)
    auto = _run_arm(spec, trace, autoscale=True, **kw)
    n_static = static_hosts if static_hosts is not None \
        else int(auto["hosts_peak"])
    template = spec.hosts[spec.autoscale.template]
    static_spec = dataclasses.replace(
        spec, hosts=(dataclasses.replace(template, count=n_static),))
    static = _run_arm(static_spec, trace, autoscale=False, **kw)
    return {
        "scenario": scenario,
        "params": {"n_steps": n_steps, "step_time": step_time,
                   "l_blk": l_blk, "alpha_accel": alpha_accel,
                   "every": every, "seed": seed,
                   "static_hosts": n_static},
        "autoscaled": auto,
        "static": static,
        "cost_ratio_vs_static": float(
            auto["cost_per_token"]
            / max(static["cost_per_token"], 1e-30)),
        "autoscale_wins": bool(
            auto["cost_per_token"] <= static["cost_per_token"] + 1e-12),
        "final_within_one_of_advice": bool(
            abs(auto["hosts_final"] - auto["recommended_final"]) <= 1),
    }
