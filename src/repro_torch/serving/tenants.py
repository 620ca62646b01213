"""Per-tenant SLO isolation bench: one declared pack, three arms.

The headline claim of the WorkloadDecl + per-tenant economics work: with
per-tenant gating on, a scan-flood adversary **cannot** push a premium
tenant's p99 per-token restore stall past its declared
`SloDecl.p99_stall_budget` — and the very same pack violates the budget
when compiled against a single shared threshold/class (the
pre-WorkloadDecl behavior).

The pack (`tenant_pack`) is three declared tenants on one small host
whose DRAM holds `dram_blobs` paused KV blobs:

  * ``premium`` — interactive chat (short think gaps), a tight deadline,
    a declared p99 stall budget, and `alpha_stall` > 0 so its stalls
    rent DRAM harder (its own tau_be widens via Eq. 1 + the stall term);
  * ``batch``   — long decodes, lazy deadline, no budget: the tenant
    that is *allowed* to absorb flash resumes under pressure;
  * ``scan``    — the adversary: a flash-crowd burst of sessions with
    long (6 s) think gaps whose paused KV is economically cold.

Why the shared arm fails: one shared class means one shared prior, and
a prior wide enough to welcome premium's 0.75 s gaps also welcomes the
flood. The burst's fresh blobs land in DRAM together, capacity pressure
demotes the *stalest* resident — the premium session paused a second
ago — and its next resume pays the flash queue. Per-tenant compilation
gives scan its own declared 6 s prior (> its tau_be), so the flood is
priced straight to flash and premium's residency is never contested.

The third arm (``no_adversary``: shared gate, scan population zeroed)
shows causality: the shared gate alone meets the budget when no flood
arrives, so the violation is the adversary's doing, not the gate's.

`run_tenant_bench` returns a JSON-stable dict, equal on every device
(virtual clock, seeded draws, greedy decode); the twin
`python -m repro_torch.benchmarks.serving_tenants` writes it. The engine
runs on `device`: the serving kernels on CUDA, their plain versions on
the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Union

import torch

from ..platform.spec import (ArrivalDecl, HierarchySpec, HostDecl,
                             PolicyDecl, SchedulerDecl, SessionShapeDecl,
                             SloDecl, TenantDecl, TierDecl, WorkloadDecl)

__all__ = ["KV_BLOB_BYTES", "tenant_pack", "run_tenant_bench"]

# one paused gemma-2b (reduced) session's KV blob at max_len=64 — the
# pack's DRAM is sized in these units and the economic policy prices
# this object size (tests assert the engine still produces this blob)
KV_BLOB_BYTES = 32768

STEP_TIME = 0.25                    # modeled seconds per decode step


def tenant_pack(*, premium_sessions: int = 4, batch_sessions: int = 3,
                scan_sessions: int = 10, dram_blobs: int = 8,
                p99_stall_budget: float = 2e-6,
                horizon_steps: int = 96, seed: int = 0) -> HierarchySpec:
    """The declared premium + batch + scan-flood pack.

    `dram_blobs` sizes the host DRAM in KV-blob units: large enough for
    every friendly paused blob (premium + batch), small enough that the
    scan burst overflows it. `p99_stall_budget` is premium's declared
    ceiling on p99 per-token restore stall (seconds/token)."""
    premium = TenantDecl(
        name="premium", n_sessions=premium_sessions,
        session=SessionShapeDecl.chat(),
        # concentrated early arrivals: the tenant is mid-conversation
        # (pausing every few steps) when the flood lands
        arrival=ArrivalDecl(kind="flash_crowd", peak_step=4,
                            burst_len=8, baseline=0.01),
        slo=SloDecl(deadline_steps=4, p99_stall_budget=p99_stall_budget,
                    alpha_stall=4.0))
    batch = TenantDecl(
        name="batch", n_sessions=batch_sessions,
        session=SessionShapeDecl.moe_heavy(tokens_per_turn=10),
        arrival=ArrivalDecl(kind="stationary"),
        slo=SloDecl(deadline_steps=12))
    scan = TenantDecl(
        name="scan", n_sessions=scan_sessions,
        session=SessionShapeDecl.scan(),
        # the whole flood arrives inside two steps and pauses together
        arrival=ArrivalDecl(kind="flash_crowd", peak_step=12,
                            burst_len=2, baseline=0.01),
        slo=SloDecl(deadline_steps=30))
    workload = WorkloadDecl(tenants=(premium, batch, scan),
                            horizon_steps=horizon_steps, seed=seed,
                            isolation="per-tenant")
    dram = TierDecl(capacity_bytes=float(dram_blobs * KV_BLOB_BYTES),
                    read_bw=45e9, read_latency=5e-7)
    chat_gap = premium.session.gap_steps * STEP_TIME
    return HierarchySpec(
        hosts=(HostDecl(tiers={"dram": dram}),),
        policy=PolicyDecl.economic(l_blk=KV_BLOB_BYTES),
        step_time=STEP_TIME,
        # the *shared* arm's single class gets the optimistic chat-gap
        # prior — the honest version of the control: the shared gate is
        # tuned for its premium users, and that is exactly what lets
        # the flood in (per-tenant arms seed per-tenant priors instead)
        class_priors={"kv": chat_gap},
        scheduler=SchedulerDecl(pause_idle_steps=0, prefetch_lead=0),
        workload=workload)


def _shared(spec: HierarchySpec) -> HierarchySpec:
    return dataclasses.replace(
        spec, workload=dataclasses.replace(spec.workload,
                                           isolation="shared"))


def _without_tenant(spec: HierarchySpec, name: str) -> HierarchySpec:
    tenants = tuple(t for t in spec.workload.tenants if t.name != name)
    return dataclasses.replace(
        spec, workload=dataclasses.replace(spec.workload,
                                           tenants=tenants))


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def bench_weights(cfg, device):
    """Seed-0 native weights for `cfg`, drawn on the CPU and moved to
    `device`. Native init draws from the device's own generator, so the
    same seed drawn on another device gives other weights; drawing once
    on the CPU keeps the bench's sessions the same on every device."""
    from ..models import model as M
    return _to(M.init_params(cfg, 0, device="cpu"), device)


def _run_arm(spec: HierarchySpec, cfg, params, *, device,
             max_slots: int, max_len: int,
             trace_sink: Optional[Dict[str, object]] = None,
             arm: str = "") -> Dict[str, object]:
    from ..platform.compiler import Platform
    platform = Platform.compile(spec, device=device)
    if trace_sink is not None and platform.tracer is not None:
        trace_sink[arm] = platform.tracer
    sched = platform.scheduler(cfg, params, max_slots=max_slots,
                               max_len=max_len,
                               compute_dtype=params["embed"].dtype)
    report = sched.run(platform.jobs(vocab=cfg.vocab))
    gate = platform.policy(0)
    taus = {t.name: float(gate.tau_for(("kv", f"{t.name}/000")))
            for t in spec.workload.tenants}
    gs = getattr(gate, "gate_stats", None)
    out: Dict[str, object] = {"report": report, "tau_be": taus}
    if gs is not None:
        out["gate"] = {k: int(v) for k, v in
                       dataclasses.asdict(gs).items()}
    return out


def run_tenant_bench(spec: Optional[HierarchySpec] = None, *,
                     max_slots: int = 4, max_len: int = 64,
                     trace_sink: Optional[Dict[str, object]] = None,
                     device: Optional[Union[str, torch.device]] = None,
                     params=None, cfg=None) -> Dict[str, object]:
    """Replay the pack through all three arms and judge the SLOs.

    Returns a deterministic, JSON-serializable dict: per-arm scheduler
    reports (with per-tenant p99 stall accounting, the Eq. 1 stall
    ledger and budget burn), per-arm thresholds, declared budgets, and
    the isolation verdicts. When the spec declares
    `observability.trace`, pass `trace_sink={}` to collect each arm's
    `Tracer` (arm name -> tracer) for Perfetto export.

    The model is `cfg`, reduced gemma-2b when None (the reference's).
    `params` are its weights on `device`, computed in their own dtype;
    when None, `bench_weights(cfg, device)`. `device` is where every
    arm's engine decodes and its gates keep their reuse sketch: CUDA
    unless the caller asks for the CPU."""
    from .._device import resolve_device
    from ..configs import get_config

    device = resolve_device(device)
    spec = tenant_pack() if spec is None else spec
    spec.validate()
    if cfg is None:
        cfg = get_config("gemma-2b", reduced=True)
    if params is None:
        params = bench_weights(cfg, device)

    arms = {
        "gated": spec,
        "shared": _shared(spec),
        "no_adversary": _without_tenant(_shared(spec), "scan"),
    }
    out: Dict[str, object] = {
        "spec": {"workload_seed": spec.workload.seed,
                 "horizon_steps": spec.workload.horizon_steps,
                 "dram_bytes": spec.hosts[0].dram_capacity(),
                 "step_time": STEP_TIME}}
    for name, arm_spec in arms.items():
        out[name] = _run_arm(arm_spec, cfg, params, device=device,
                             max_slots=max_slots, max_len=max_len,
                             trace_sink=trace_sink, arm=name)

    budgets = {t.name: t.slo.p99_stall_budget
               for t in spec.workload.tenants
               if t.slo.p99_stall_budget is not None}
    out["budgets"] = budgets

    def p99(arm: str, tenant: str) -> float:
        tenants = out[arm]["report"].get("tenants", {})
        cell = tenants.get(tenant)
        return float(cell["p99_per_token_stall"]) if cell else 0.0

    verdicts: Dict[str, object] = {}
    for tenant, budget in budgets.items():
        v = {
            "budget": budget,
            "gated_p99": p99("gated", tenant),
            "shared_p99": p99("shared", tenant),
            "no_adversary_p99": p99("no_adversary", tenant),
        }
        v["gated_meets_budget"] = bool(v["gated_p99"] <= budget)
        v["shared_violates"] = bool(v["shared_p99"] > budget)
        v["adversary_causal"] = bool(v["no_adversary_p99"] <= budget)
        v["isolation_effective"] = bool(
            v["gated_meets_budget"] and v["shared_violates"]
            and v["adversary_causal"])
        verdicts[tenant] = v
    out["verdicts"] = verdicts
    out["isolation_effective"] = bool(all(
        v["isolation_effective"] for v in verdicts.values()))
    return out
