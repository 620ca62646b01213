"""Declarative platform API: `HierarchySpec` -> compiled `Platform`.

One validated spec (per-host tier geometry, fabric topology, policy,
workload priors, clock source) compiles into the whole runtime — clock,
per-host stores with per-host `EconomicGate`s, the capacity-weighted
sharded fabric, and an attached `ProvisionAdvisor` whose recommendation
`Platform.autoscale` turns into `add_host`/`remove_host` actions (the
closed provisioning loop). Specs round-trip through JSON byte for byte
(the reference package writes the same bytes), so benchmarks and CI pin
scenarios instead of constructor call sites.

    from repro_torch.platform import (HierarchySpec, HostDecl,
                                      PolicyDecl, Platform)
    spec = HierarchySpec(hosts=(HostDecl(count=4),),
                         policy=PolicyDecl.economic(l_blk=128 << 10))
    platform = Platform.compile(spec)           # device="cpu" without CUDA

A declared `WorkloadDecl` compiles through `compile_workload` into
tenant-tagged jobs for `Platform.scheduler` (`Platform.jobs`).
`run_autoscale_bench` prices the closed loop against a peak-provisioned
static fleet, and `run_failover_bench` kills the busiest host at the
diurnal peak under replication factors 1-3 (`Platform.fail_host`, then
`Platform.repair`).
"""
from .autoscale import (AutoscaleDecision, Autoscaler,  # noqa: F401
                        default_autoscale_spec, run_autoscale_bench)
from .compiler import Platform  # noqa: F401
from .failover import default_failover_spec, run_failover_bench  # noqa: F401
from .handles import Handle, KvSession  # noqa: F401
from .roofline_hook import measured_step_time  # noqa: F401
from .spec import (ArrivalDecl, AutoscaleDecl,  # noqa: F401
                   HierarchySpec, HostDecl, NetDecl, ObservabilityDecl,
                   PolicyDecl, PoolDecl, SchedulerDecl, SessionShapeDecl,
                   SloDecl, TenantDecl, TierDecl, TopologyDecl,
                   WorkloadDecl, gpu_flash_tier)
from .workload import (CompiledWorkload, compile_workload,  # noqa: F401
                       tenant_classifier)

__all__ = [
    "ArrivalDecl", "AutoscaleDecision", "AutoscaleDecl", "Autoscaler",
    "CompiledWorkload", "Handle", "HierarchySpec", "HostDecl",
    "KvSession", "NetDecl", "ObservabilityDecl", "Platform",
    "PolicyDecl", "PoolDecl", "SchedulerDecl",
    "SessionShapeDecl", "SloDecl", "TenantDecl", "TierDecl",
    "TopologyDecl", "WorkloadDecl",
    "compile_workload", "default_autoscale_spec", "gpu_flash_tier",
    "default_failover_spec", "measured_step_time",
    "run_autoscale_bench", "run_failover_bench", "tenant_classifier",
]
