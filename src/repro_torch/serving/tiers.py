"""Fourth-tier serving bench: two new Eq. 1 columns, priced end to end.

The headline claim: the two new tier shapes each earn their Eq. 1
column on the workload shape that motivates them.

  * ``gpu_flash`` (BaM-style GPU-direct flash) drops the host-CPU term
    from the flash column — the accelerator's submission engine drives
    the device queue at deep queue depth, so a flash resume costs
    `alpha_submit/iops_submit` per IO instead of `alpha_core/iops_core`
    and services at the IOPS ladder's saturated rung. It should win on
    MoE-heavy / scan shapes whose paused KV is *economically cold*
    (reuse beyond every DRAM band): those resumes pay the flash path no
    matter what, so cheapening the path is the whole game.
  * The fleet-shared far-memory **pool** rents DRAM-class residency at
    `rent_factor` of the local rate (uncorrelated per-host peaks
    multiplex onto one shared slab). It should win on staggered-peak /
    diurnal multi-tenant shapes whose think gaps land *inside the pool
    band* `[tau_be, tau_pool)`: too cold for full-rate local DRAM, too
    hot to re-read from flash.

`run_tiers_bench` replays each scenario pack through four arms of the
same declared platform — ``baseline`` (3-tier), ``+gpu_flash``,
``+pool``, ``both`` — and prices each run with the fleet-shared rates
(`autopilot.bench.pricing_rates`): DRAM rent on provisioned capacity,
wire + page + per-IO path costs off the runtime's own lane counters,
pool rent on the pool's measured byte-seconds at its discounted rate,
and stalled-accelerator rent (`alpha_accel`) on the scheduler's
per-token stall. An arm *wins* iff its modeled $/token is strictly
below baseline at equal-or-lower per-token stall. The baseline
platform's `ProvisionAdvisor.advise_tiers` four-arm comparison is run
on the same observed reuse stream and its recommendation is checked
against the measured winners.

The JSON is deterministic (virtual clock, seeded draws, greedy decode)
and equal on every device; the twin
`python -m repro_torch.benchmarks.serving_tiers` writes it. The engines
run on `device`: the serving kernels on CUDA, their plain versions on
the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Union

import torch

from ..core.policy import Tier
from ..platform.spec import (ArrivalDecl, HierarchySpec, HostDecl,
                             PolicyDecl, PoolDecl, SchedulerDecl,
                             SessionShapeDecl, SloDecl, TenantDecl,
                             TierDecl, WorkloadDecl, gpu_flash_tier)
from .tenants import KV_BLOB_BYTES, STEP_TIME, bench_weights

__all__ = ["moe_scan_pack", "diurnal_pack", "scenario_packs",
           "default_pool_decl", "run_tiers_bench"]

# stalled-accelerator rent multiplier (Eq. 1 alpha_stall as a price) —
# matches the admission/autoscale benches so $/token stays comparable
ALPHA_ACCEL = 4.0
# accelerator submission-engine $/IO — economics-column defaults
ALPHA_SUBMIT = 0.5
IOPS_SUBMIT = 2e7

ARM_ORDER = ("baseline", "gpu_flash", "pool", "both")

# the packs' host flash is QLC-class (slow reads, long setup): the
# baseline arm's resumes visibly pay this queue, while the gpu_flash
# tier keeps its default BaM geometry (fast NAND behind the
# accelerator-submission queue) and the pool is CXL-class DRAM — so
# the per-token stall deltas between arms are physical, not epsilon
_SLOW_FLASH = TierDecl(capacity_bytes=float(4 << 30), read_bw=2e9,
                       read_latency=2e-4)


# ------------------------------------------------------- scenario packs
def moe_scan_pack(*, moe_sessions: int = 4, scan_sessions: int = 8,
                  dram_blobs: int = 6, horizon_steps: int = 96,
                  seed: int = 0) -> HierarchySpec:
    """MoE-heavy decodes + a cold-scan tenant: the gpu_flash shape.

    The scan tenant's think gaps (10 s) sit beyond every DRAM band —
    local (tau_be ~ 2.3 s at this geometry) *and* pooled (tau_pool
    ~ 8.3 s) — so its paused KV is priced to flash in every arm and the
    only lever left is the flash path itself. The MoE tenant supplies
    long decodes (tokens) and enough DRAM pressure that the small host
    DRAM stays contested."""
    moe = TenantDecl(
        name="moe", n_sessions=moe_sessions,
        session=SessionShapeDecl.moe_heavy(gap_steps=4),
        arrival=ArrivalDecl(kind="stationary"),
        slo=SloDecl(deadline_steps=12))
    scan = TenantDecl(
        name="scan", n_sessions=scan_sessions,
        # 40 steps * 0.25 s = 10 s think gaps: beyond tau_pool, so the
        # pool arm cannot claim these blobs — only the path can change
        session=SessionShapeDecl.scan(gap_steps=40, n_turns=3),
        arrival=ArrivalDecl(kind="flash_crowd", peak_step=6,
                            burst_len=4, baseline=0.01),
        slo=SloDecl(deadline_steps=48))
    workload = WorkloadDecl(tenants=(moe, scan),
                            horizon_steps=horizon_steps, seed=seed,
                            isolation="per-tenant")
    dram = TierDecl(capacity_bytes=float(dram_blobs * KV_BLOB_BYTES),
                    read_bw=45e9, read_latency=5e-7)
    return HierarchySpec(
        hosts=(HostDecl(tiers={"dram": dram, "flash": _SLOW_FLASH}),),
        policy=PolicyDecl.economic(l_blk=KV_BLOB_BYTES),
        step_time=STEP_TIME,
        scheduler=SchedulerDecl(pause_idle_steps=0, prefetch_lead=0),
        workload=workload)


def diurnal_pack(*, day_sessions: int = 5, night_sessions: int = 5,
                 dram_blobs: int = 5, horizon_steps: int = 96,
                 seed: int = 0) -> HierarchySpec:
    """Staggered-peak multi-tenant chat: the pool shape.

    Two tenant populations peak at opposite ends of the horizon
    (diurnal offset), with think gaps of 4 s and 6 s — inside the pool
    band `[tau_be ~ 2.3 s, tau_pool ~ 8.3 s)` at the default pool
    geometry. Their paused KV is too cold for full-rate local DRAM
    (baseline prices it to flash and the resumes stall) but hot enough
    that discounted pooled residency beats a flash re-read. The
    staggered peaks are the multiplexing argument made flesh: one
    pool slab absorbs both tenants' paused sets because they never
    peak together."""
    day = TenantDecl(
        name="day", n_sessions=day_sessions,
        session=SessionShapeDecl.chat(n_turns=3, gap_steps=16),
        arrival=ArrivalDecl(kind="flash_crowd", peak_step=4,
                            burst_len=6, baseline=0.01),
        slo=SloDecl(deadline_steps=24))
    night = TenantDecl(
        name="night", n_sessions=night_sessions,
        session=SessionShapeDecl.chat(n_turns=3, gap_steps=24),
        arrival=ArrivalDecl(kind="flash_crowd", peak_step=40,
                            burst_len=6, baseline=0.01),
        slo=SloDecl(deadline_steps=32))
    workload = WorkloadDecl(tenants=(day, night),
                            horizon_steps=horizon_steps, seed=seed,
                            isolation="per-tenant")
    dram = TierDecl(capacity_bytes=float(dram_blobs * KV_BLOB_BYTES),
                    read_bw=45e9, read_latency=5e-7)
    return HierarchySpec(
        hosts=(HostDecl(tiers={"dram": dram, "flash": _SLOW_FLASH}),),
        policy=PolicyDecl.economic(l_blk=KV_BLOB_BYTES),
        step_time=STEP_TIME,
        scheduler=SchedulerDecl(pause_idle_steps=0, prefetch_lead=0),
        workload=workload)


def default_pool_decl(*, blobs: int = 64) -> PoolDecl:
    """CXL-class pool geometry sized in KV-blob units; rent_factor 0.25
    keeps the band `[tau_be, tau_pool)` wide (~2.3 s .. ~8.3 s at the
    gpu profile and this l_blk)."""
    return PoolDecl(capacity_bytes=float(blobs * KV_BLOB_BYTES),
                    read_bw=40e9, rtt=2e-6, rent_factor=0.25)


def scenario_packs(*, smoke: bool = False) -> Dict[str, HierarchySpec]:
    """The benchmark's scenario set (pinned small variants for `smoke`)."""
    if smoke:
        return {
            "moe_scan": moe_scan_pack(moe_sessions=2, scan_sessions=4,
                                      dram_blobs=4, horizon_steps=64),
            "diurnal": diurnal_pack(day_sessions=3, night_sessions=3,
                                    dram_blobs=3, horizon_steps=64),
        }
    return {"moe_scan": moe_scan_pack(), "diurnal": diurnal_pack()}


# ---------------------------------------------------------------- arms
def _with_gpu_flash(spec: HierarchySpec) -> HierarchySpec:
    hosts = tuple(
        dataclasses.replace(h, tiers={**h.tiers,
                                      "gpu_flash": gpu_flash_tier()})
        for h in spec.hosts)
    return dataclasses.replace(spec, hosts=hosts)


def _with_pool(spec: HierarchySpec, pool: PoolDecl) -> HierarchySpec:
    return dataclasses.replace(spec, pool=pool)


def _arms(spec: HierarchySpec,
          pool: PoolDecl) -> Dict[str, HierarchySpec]:
    return {
        "baseline": spec,
        "gpu_flash": _with_gpu_flash(spec),
        "pool": _with_pool(spec, pool),
        "both": _with_pool(_with_gpu_flash(spec), pool),
    }


# ---------------------------------------------------------- cost model
def _modeled_cost(platform, report: Dict[str, object]) -> Dict[str, float]:
    """Post-run $/token from the runtime's own counters.

    Normalized units (NAND die == 1, capital == rent), shared with the
    admission/autoscale benches via `pricing_rates`. Components:

      * dram_rent  — provisioned DRAM (+ HBM at 4x) capacity for the
        makespan; identical across arms with the same local tiers, so
        arm deltas come from the paths below.
      * flash_io   — host-flash lane: host CPU per IO + DRAM wire +
        page cost on bytes moved (the classic Eq. 1 column's numerator
        priced per event).
      * gpu_direct — gpu_flash lane: submission-engine per IO + page
        cost only; no host CPU, no host-DRAM wire (the BaM column).
      * dram_wire  — DRAM/HBM lane bytes at the wire rate.
      * pool       — fabric wire + per-IO RTT at `alpha_net`, plus the
        pool's measured byte-seconds rented at `rent_factor` of the
        local DRAM rate.
      * stall      — scheduler stall seconds priced at `ALPHA_ACCEL`
        (the stalled accelerator rents its capital while idle).

    NIC lanes between hosts are unpriced (single-host packs; replica
    traffic is identical across arms)."""
    from ..autopilot.bench import PAGE_BYTES, pricing_rates
    spec = platform.spec
    host_cfg, ssd = spec.policy.economics()
    rates = pricing_rates(host_cfg, ssd)
    page_rate = rates["page_io_cost"] / float(PAGE_BYTES)
    submit_cost = ALPHA_SUBMIT / IOPS_SUBMIT

    makespan = float(report["makespan"])
    tokens = max(int(report["tokens"]), 1)

    dram_rent = 0.0
    flash_io = 0.0
    gpu_direct = 0.0
    dram_wire = 0.0
    accesses = 0
    for store in platform.fabric.hosts.values():
        cap = {t: s.capacity_bytes for t, s in store.specs.items()}
        dram_rent += (cap.get(Tier.DRAM, 0.0)
                      + 4.0 * cap.get(Tier.HBM, 0.0)
                      ) * makespan * rates["rent_rate"]
        for lane, st in store.runtime.qstats.items():
            if lane == Tier.FLASH:
                flash_io += (st.submitted * rates["host_io_cost"]
                             + st.bytes_moved * (rates["dram_wire_rate"]
                                                 + page_rate))
            elif lane == Tier.GPU_FLASH:
                gpu_direct += (st.submitted * submit_cost
                               + st.bytes_moved * page_rate)
            elif lane in (Tier.DRAM, Tier.HBM):
                dram_wire += st.bytes_moved * rates["dram_wire_rate"]
        accesses += sum(s.hits for s in store.stats.values())

    pool_cost = 0.0
    pool = platform.fabric.pool
    if pool is not None:
        alpha_net = spec.pool.alpha_net
        for st in pool.runtime.qstats.values():
            pool_cost += (st.submitted * alpha_net * spec.pool.rtt
                          + st.bytes_moved * alpha_net / spec.pool.read_bw)
        pool_cost += (pool.byte_seconds() * rates["rent_rate"]
                      * spec.pool.rent_factor)
        accesses += pool.stats.gets

    stall_seconds = float(report["per_token_stall"]) * tokens
    stall = stall_seconds * ALPHA_ACCEL
    total = (dram_rent + flash_io + gpu_direct + dram_wire + pool_cost
             + stall)
    return {
        "dram_rent": dram_rent,
        "flash_io": flash_io,
        "gpu_direct": gpu_direct,
        "dram_wire": dram_wire,
        "pool": pool_cost,
        "stall": stall,
        "stall_seconds": stall_seconds,
        "total": total,
        "tokens": float(tokens),
        "accesses": float(accesses),
        "per_token": total / tokens,
        "per_token_stall": float(report["per_token_stall"]),
    }


# --------------------------------------------------------------- runner
def _run_arm(spec: HierarchySpec, cfg, params, *, device,
             max_slots: int, max_len: int):
    from ..platform.compiler import Platform
    platform = Platform.compile(spec, device=device)
    sched = platform.scheduler(cfg, params, max_slots=max_slots,
                               max_len=max_len,
                               compute_dtype=params["embed"].dtype)
    report = sched.run(platform.jobs(vocab=cfg.vocab))
    gate = platform.policy(0)
    costs = _modeled_cost(platform, report)
    out: Dict[str, object] = {
        "report": report,
        "costs": costs,
        "tau_be": float(getattr(gate, "tau_be", 0.0)),
    }
    tau_pool = getattr(gate, "tau_pool", None)
    if tau_pool is not None:
        out["tau_pool"] = float(tau_pool)
    gs = getattr(gate, "gate_stats", None)
    if gs is not None:
        out["gate"] = {k: int(v) for k, v in
                       dataclasses.asdict(gs).items()}
    if platform.fabric.pool is not None:
        out["pool_stats"] = platform.fabric.pool.snapshot_stats()
    return out, platform


def run_tiers_bench(packs: Optional[Dict[str, HierarchySpec]] = None, *,
                    pool: Optional[PoolDecl] = None, smoke: bool = False,
                    max_slots: int = 4, max_len: int = 64,
                    device: Optional[Union[str, torch.device]] = None,
                    params=None, cfg=None) -> Dict[str, object]:
    """Replay each scenario pack through the four arms and judge them.

    Returns a deterministic, JSON-serializable dict: per-scenario,
    per-arm scheduler reports, modeled cost breakdowns, gate/pool
    stats; per-scenario win verdicts (strictly cheaper $/token at
    equal-or-lower per-token stall than baseline) and the baseline
    advisor's `advise_tiers` recommendation with an agreement flag.

    The model is `cfg`, reduced gemma-2b when None (the reference's).
    `params` are its weights on `device`, computed in their own dtype;
    when None, `bench_weights(cfg, device)`. `device` is where every
    arm's engine decodes and its gates keep their reuse sketch: CUDA
    unless the caller asks for the CPU."""
    from .._device import resolve_device
    from ..configs import get_config

    device = resolve_device(device)
    packs = scenario_packs(smoke=smoke) if packs is None else packs
    pool = default_pool_decl() if pool is None else pool
    if cfg is None:
        cfg = get_config("gemma-2b", reduced=True)
    if params is None:
        params = bench_weights(cfg, device)

    out: Dict[str, object] = {
        "pool_decl": {"capacity_bytes": pool.capacity_bytes,
                      "read_bw": pool.read_bw, "rtt": pool.rtt,
                      "rent_factor": pool.rent_factor,
                      "alpha_net": pool.alpha_net},
        "alpha_accel": ALPHA_ACCEL,
    }
    for scen, spec in packs.items():
        spec.validate()
        cell: Dict[str, object] = {
            "horizon_steps": spec.workload.horizon_steps,
            "workload_seed": spec.workload.seed,
            "dram_bytes": spec.hosts[0].dram_capacity(),
        }
        baseline_platform = None
        for arm, arm_spec in _arms(spec, pool).items():
            cell[arm], platform = _run_arm(
                arm_spec, cfg, params, device=device,
                max_slots=max_slots, max_len=max_len)
            if arm == "baseline":
                baseline_platform = platform

        base = cell["baseline"]["costs"]

        def _wins(arm_costs: Dict[str, float]) -> bool:
            return bool(
                arm_costs["per_token"] < base["per_token"] - 1e-15
                and (arm_costs["per_token_stall"]
                     <= base["per_token_stall"] + 1e-12))

        verdicts = {arm: _wins(cell[arm]["costs"])
                    for arm in ARM_ORDER if arm != "baseline"}
        cell["wins"] = verdicts

        # the advisor's four-arm comparison on the observed reuse
        # stream (baseline platform: its tracker saw the un-pooled run)
        accesses = base["accesses"]
        makespan = float(cell["baseline"]["report"]["makespan"])
        rate = accesses / makespan if makespan > 0 else 1.0
        advice = baseline_platform.advise_tiers(
            access_rate=max(rate, 1e-9), object_bytes=KV_BLOB_BYTES,
            pool_bw=pool.read_bw, pool_rtt=pool.rtt,
            rent_factor=pool.rent_factor, alpha_net=pool.alpha_net,
            alpha_stall=ALPHA_ACCEL)
        winners = sorted(a for a, w in verdicts.items() if w)
        agreement = (advice.recommended_arm in winners if winners
                     else advice.recommended_arm == "baseline")
        cell["advice"] = advice.as_dict()
        cell["advice_agreement"] = bool(agreement)
        out[scen] = cell

    out["gpu_flash_wins_somewhere"] = bool(any(
        out[s]["wins"]["gpu_flash"] for s in packs))
    out["pool_wins_somewhere"] = bool(any(
        out[s]["wins"]["pool"] for s in packs))
    return out
