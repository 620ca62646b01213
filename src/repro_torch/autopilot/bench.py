"""Autopilot serving benchmark: break-even admission vs static placement.

Replays a scenario trace (`autopilot.traces`) against a capacity-bound
`TieredStore` on the virtual clock under three placement policies:

  * ``economic``  — `EconomicGate`: admission/demotion by tracked reuse
                    interval vs the calibrated break-even threshold;
  * ``dram``      — admit everything to DRAM, capacity pressure evicts
                    (the LRU-ish seed behavior);
  * ``flash``     — keep everything on flash, every access pays the
                    queueing-aware fetch.

Each access is demand-driven (the restore stalls until served — the
admission question is exactly about which accesses may stall), and each
step then advances the clock by `step_time` of modeled decode compute.

Modeled $/token prices what the placement actually consumed, in the
paper's normalized units (NAND die == 1, capital cost == rent rate):

  * DRAM rent        resident byte-seconds x alpha_h_dram/c_h_dram_die
  * DRAM wire        tier bytes moved x alpha_h_dram/b_h_dram_die
  * flash IO         4KiB pages moved x ssd.cost/iops_ssd_peak(4KiB)
  * host CPU         IOs x alpha_core/iops_core
  * stall            stall seconds x alpha_accel — rent of the serving
                     resource a demand miss idles, in the same
                     capital-as-rent units as alpha_core (default 4.0:
                     roughly one GPU-host core-equivalent per stream)

so always-DRAM pays rent for squatters, always-flash pays stalled
accelerator time, and the gate pays only for what clears break-even.
The gate's threshold prices the miss the same way the cost model does
(`from_break_even(alpha_stall=..., fetch_seconds=...)`), so admission
and accounting agree on what a stall is worth.
The win criterion per scenario is the acceptance bound: the gate's
$/token must not exceed the best static baseline's while its per-token
stall does not exceed that same baseline's.

Everything runs on one `VirtualClock` with seeded traces, and the gate's
sketch gives the reference's numpy oracle bit for bit on either device
(`device=`: the reuse_sketch kernel on CUDA, its plain version on the
CPU), so the record written through `obs.bench_json` is byte-identical
across runs, across devices, and to the reference's
`benchmarks/serving_autopilot.py`.
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch

from .._device import resolve_device
from ..core.economics import GPU_GDDR, HostConfig
from ..core.policy import Tier, TieringPolicy
from ..core.ssd_model import SsdConfig, iops_ssd_peak, storage_next_ssd
from ..runtime.clock import VirtualClock
from ..runtime.service import SsdQueueModel
from ..runtime.tiers import TierSpec, TieredStore
from .advisor import ProvisionAdvisor
from .gate import EconomicGate
from .traces import SCENARIOS, generate

MODES = ("economic", "dram", "flash")

PAGE_BYTES = 4096               # flash IO accounting granularity


def pricing_rates(host: HostConfig, ssd: SsdConfig) -> Dict[str, float]:
    """The modeled $/unit rates (normalized units: NAND die == 1,
    capital == rent) every cost-reporting bench shares — one place, so
    the admission benchmark and the autoscale benchmark stay
    comparable: DRAM rent per byte-second, DRAM wire per byte moved,
    flash IO per `PAGE_BYTES` page, host CPU per IO."""
    return {
        "rent_rate": host.alpha_h_dram / host.c_h_dram_die,
        "dram_wire_rate": host.alpha_h_dram / host.b_h_dram_die,
        "page_io_cost": ssd.cost / float(iops_ssd_peak(ssd, PAGE_BYTES)),
        "host_io_cost": host.alpha_core / host.iops_core,
    }


def _policy_for(mode: str, host: HostConfig, ssd: SsdConfig, l_blk: int,
                alpha_accel: float, sim_cfg, device: torch.device):
    if mode == "economic":
        # the threshold prices the miss fully: SSD IO + the engine
        # stalled for the modeled demand-fetch time (AI-era Eq. 1)
        fetch = SsdQueueModel.shared(sim_cfg).service(l_blk, 1).total
        return EconomicGate.from_break_even(
            host, ssd, l_blk, alpha_stall=alpha_accel,
            fetch_seconds=fetch, device=device)
    if mode == "dram":
        # everything wants DRAM; only capacity pressure demotes
        return TieringPolicy(tau_hot=1e-12, tau_be=1e12)
    if mode == "flash":
        # everything belongs on flash (the pinned-flash bench policy)
        return TieringPolicy(tau_hot=1e-12, tau_be=1e-9, ema_alpha=1.0)
    raise ValueError(f"unknown mode {mode!r}; one of {MODES}")


def run_scenario(scenario: str, mode: str, *,
                 n_steps: int = 240,
                 step_time: float = 0.25,
                 l_blk: int = 128 << 10,
                 tokens_per_step: int = 16,
                 dram_frac: float = 0.35,
                 alpha_accel: float = 4.0,
                 host: HostConfig = GPU_GDDR,
                 ssd: Optional[SsdConfig] = None,
                 seed: int = 0,
                 sim_cfg=None,
                 obs=None,
                 device: Optional[Union[str, torch.device]] = None
                 ) -> Dict[str, object]:
    """One (scenario, policy) cell; returns a JSON-ready record. The
    economic gate's sketch lives on `device` (CUDA unless the caller
    names another); the record does not depend on it.

    `obs` (a `repro_torch.obs.Observability`) attaches the observability
    plane: transfer spans, stall attribution and gate-decision instants
    land in its tracer/metrics/ledger. The modeled record is identical
    with or without it."""
    device = resolve_device(device)
    ssd = ssd or storage_next_ssd()
    trace = generate(scenario, n_steps=n_steps, step_time=step_time,
                     seed=seed)
    n_keys = len(trace.distinct_keys())
    total_bytes = n_keys * l_blk
    # DRAM is provisioned as a fraction of the *recurring* working set
    # (keys touched more than once): one-touch flood keys must not
    # inflate the capacity they are attacking
    counts: Dict[tuple, int] = {}
    for step in trace.steps:
        for key in step:
            counts[key] = counts.get(key, 0) + 1
    recurring_bytes = sum(1 for c in counts.values() if c > 1) * l_blk
    specs = {
        Tier.HBM: TierSpec(2 * l_blk, 819e9, 1e-7),
        Tier.DRAM: TierSpec(max(dram_frac * recurring_bytes, 2 * l_blk),
                            45e9, 5e-7),
        Tier.FLASH: TierSpec(max(64 * total_bytes, 1 << 30), 7e9, 2e-5),
    }
    policy = _policy_for(mode, host, ssd, l_blk, alpha_accel, sim_cfg,
                         device)
    if obs is not None and hasattr(policy, "obs"):
        policy.obs = obs
    clock = VirtualClock()
    store = TieredStore(policy, specs=specs, clock=clock, sim_cfg=sim_cfg,
                        obs=obs, label=f"{scenario}/{mode}")
    blob = np.zeros(max(l_blk // 4, 1), np.float32)
    put_tier = Tier.FLASH if mode == "flash" else Tier.DRAM

    total_stall = 0.0
    first_touches = 0
    byte_seconds = {Tier.HBM: 0.0, Tier.DRAM: 0.0}
    last_t = clock.now()
    for step in trace.steps:
        for key in step:
            if store.tier_of(key) is None:
                store.put(key, blob, tier=put_tier)
                first_touches += 1
            else:
                t0 = clock.now()
                store.get(key)
                total_stall += clock.now() - t0
        clock.advance(step_time)
        now = clock.now()
        dt = now - last_t
        for t in byte_seconds:
            byte_seconds[t] += store.used_bytes(t) * dt
        last_t = now
    horizon = clock.now()
    store.runtime.drain()
    store.flush_deferred_writes()

    # ----------------------------------------------------------- cost model
    rates = pricing_rates(host, ssd)
    rent_rate = rates["rent_rate"]                         # $/(B*s)
    dram_wire_rate = rates["dram_wire_rate"]               # $/B
    page_io_cost = rates["page_io_cost"]
    host_io_cost = rates["host_io_cost"]

    q = store.runtime.qstats
    flash_pages = -(-q[Tier.FLASH].bytes_moved // PAGE_BYTES)
    dram_bytes_moved = q[Tier.DRAM].bytes_moved + q[Tier.HBM].bytes_moved
    total_ios = sum(s.submitted for s in q.values())

    tokens = trace.n_steps * tokens_per_step
    cost = {
        "dram_rent": byte_seconds[Tier.DRAM] * rent_rate
        + byte_seconds[Tier.HBM] * 4.0 * rent_rate,
        "dram_wire": dram_bytes_moved * dram_wire_rate,
        "flash_io": flash_pages * page_io_cost,
        "host_cpu": total_ios * host_io_cost,
        "stall": total_stall * alpha_accel,
    }
    total_cost = sum(cost.values())

    flash = store.stats[Tier.FLASH]
    out: Dict[str, object] = {
        "scenario": scenario,
        "mode": mode,
        "tokens": float(tokens),
        "accesses": float(trace.accesses),
        "first_touches": float(first_touches),
        "horizon": float(horizon),
        "total_stall": float(total_stall),
        "per_token_stall": float(total_stall / max(tokens, 1)),
        "cost_total": float(total_cost),
        "cost_per_token": float(total_cost / max(tokens, 1)),
        "dram_resident_mib_mean": float(
            byte_seconds[Tier.DRAM] / max(horizon, 1e-12) / 2**20),
        "flash_reads": float(flash.bytes_read),
        "promotions": float(sum(s.promotions for s in
                                store.stats.values())),
        "demotions": float(sum(s.demotions for s in
                               store.stats.values())),
    }
    out.update({f"cost_{k}": float(v) for k, v in cost.items()})
    if mode == "economic":
        gs = policy.gate_stats
        out["gate"] = {
            "tau_be": float(policy.tau_be),
            "admits_dram": float(gs.admits_dram),
            "admits_flash": float(gs.admits_flash),
            "readmits_measured": float(gs.readmits_measured),
            "prior_decisions": float(gs.prior_decisions),
            "cold_defaults": float(gs.cold_defaults),
        }
        advisor = ProvisionAdvisor(host, ssd, l_blk)
        out["advice"] = _json_safe(
            advisor.advise(policy.tracker, store=store).as_dict())
    return out


def _json_safe(obj):
    """inf/nan are not valid JSON: encode as strings, recurse."""
    if isinstance(obj, dict):
        return {k: _json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_safe(v) for v in obj]
    if isinstance(obj, float) and not np.isfinite(obj):
        return repr(obj)
    return obj


def compare_scenario(scenario: str, **kw) -> Dict[str, object]:
    """All three modes on one scenario + the acceptance verdict: the
    gate wins when its $/token does not exceed the best static
    baseline's and its per-token stall does not exceed that same
    baseline's."""
    runs = {mode: run_scenario(scenario, mode, **kw) for mode in MODES}
    static = min(("dram", "flash"),
                 key=lambda m: runs[m]["cost_per_token"])
    gate, best = runs["economic"], runs[static]
    eps = 1e-12
    wins = (gate["cost_per_token"] <= best["cost_per_token"] + eps
            and gate["per_token_stall"] <= best["per_token_stall"] + eps)
    return {
        "scenario": scenario,
        "runs": runs,
        "best_static": static,
        "cost_ratio_vs_best_static": float(
            gate["cost_per_token"] / max(best["cost_per_token"], 1e-30)),
        "gate_wins": bool(wins),
    }


def run_suite(scenarios=SCENARIOS, **kw) -> Dict[str, object]:
    cells = [compare_scenario(s, **kw) for s in scenarios]
    return {
        "scenarios": cells,
        "wins": int(sum(c["gate_wins"] for c in cells)),
        "cells": len(cells),
    }
