"""Platform — the compiled runtime behind a `HierarchySpec`.

`Platform.compile(spec)` assembles in one pass the injected clock, N
per-host `TieredStore`s (each with its own tier geometry and its own
policy — per-host `EconomicGate`s sharing one fleet-wide `ReuseTracker`
under the economic policy), the sharded fabric with a capacity-weighted
consistent-hash ring, the NIC/topology service models, and an attached
`ProvisionAdvisor`. Economics and topology are inputs; nothing is
plumbing.

The facade hands out uniform capabilities:

    platform = Platform.compile(spec)           # CUDA unless device= says
    sess = platform.kv_session("user-42", host=1)
    sess.save(blob); h = sess.prefetch(); ...; blob = h.result()
    es = platform.expert_store(n_layers=4, n_experts=8)
    eng = platform.engine(cfg, params, host=0)
    sched = platform.scheduler(cfg, params)     # continuous batching
    sched.run(platform.jobs(vocab=cfg.vocab))   # the declared workload
    advice = platform.advise()
    platform.autoscale(step)                    # closed provisioning loop
    platform.fail_host(2)                       # unplanned failure
    platform.repair()                           # paced re-replication
    platform.advise_availability()              # replication pricing

`autoscale` lets the advisor *drive* `add_host`/`remove_host` (under
the spec's rebalance pacer and autoscale bounds) instead of merely
advising — see `repro_torch.platform.autoscale`.

`device` is where the economic gates keep their reuse sketch and where
`engine` and `scheduler` decode; it resolves to CUDA unless the caller
asks for the CPU.

A spec with `pool=` compiles the fleet-shared far-memory pool
(`runtime.pool.PooledStore`) into the fabric, and a host declaring a
"gpu_flash" tier gets a gate that routes gate-cold admissions down the
GPU-direct path.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Union

import torch

from .._device import resolve_device
from ..autopilot.advisor import ProvisionAdvice, ProvisionAdvisor
from ..autopilot.gate import EconomicGate
from ..autopilot.reuse import ReuseTracker
from ..core.policy import TieringPolicy
from ..obs import Observability
from ..runtime.clock import VirtualClock, WallClock
from ..runtime.fabric import RebalanceStats, ShardedTieredStore
from ..runtime.service import NetQueueModel, SsdQueueModel
from .handles import Handle, KvSession
from .spec import HierarchySpec, PolicyDecl

__all__ = ["Platform", "Handle", "KvSession"]


class Platform:
    """Compiled hierarchy: clock + fabric + policies + advisor, behind
    capability handles. Construct via `Platform.compile(spec)`."""

    def __init__(self, spec: HierarchySpec, clock, fabric, *,
                 tracker: Optional[ReuseTracker] = None,
                 advisor: Optional[ProvisionAdvisor] = None,
                 step_time: float = 0.0,
                 obs: Optional[Observability] = None,
                 device: Optional[torch.device] = None):
        self.spec = spec
        self.clock = clock
        self.fabric = fabric
        self.tracker = tracker
        self.advisor = advisor
        self.step_time = step_time
        self.obs = obs if obs is not None else Observability()
        self.device = device
        self._workload = None
        self._autoscaler = None

    # ------------------------------------------------------ observability
    @property
    def tracer(self):
        """Causal tracer (None unless spec.observability.trace)."""
        return self.obs.tracer

    @property
    def metrics(self):
        """`MetricsRegistry` (None when spec.observability.metrics off)."""
        return self.obs.metrics

    @property
    def ledger(self):
        """The fleet's always-on Eq. 1 stall ledger."""
        return self.obs.ledger

    # ------------------------------------------------------------- compile
    @classmethod
    def compile(cls, spec: HierarchySpec, *, sim_cfg=None,
                device: Optional[Union[str, torch.device]] = None
                ) -> "Platform":
        """Validate `spec` and assemble the runtime. `sim_cfg` (a
        `repro_torch.ssdsim.SimConfig`) overrides the flash calibration
        for every host — programmatic only, like a policy factory.
        `device` holds the economic gates' reuse sketch and is the
        engines' default device: CUDA unless the caller asks for the
        CPU."""
        spec.validate()
        device = resolve_device(device)
        clock = VirtualClock(spec.t0) if spec.clock == "virtual" \
            else WallClock()

        tracker: Optional[ReuseTracker] = None
        advisor: Optional[ProvisionAdvisor] = None
        decl = spec.policy
        hosts = spec.expanded_hosts()
        if callable(decl) and not isinstance(decl, PolicyDecl):
            factory = decl
        elif decl.kind == "static":
            def factory(_h, _d=decl):
                return TieringPolicy(tau_hot=_d.tau_hot, tau_be=_d.tau_be,
                                     hysteresis=_d.hysteresis,
                                     ema_alpha=_d.ema_alpha)
        else:
            host_cfg, ssd = decl.economics()
            workload = spec.workload
            tenants = workload.tenants if workload is not None else ()
            # one fleet-wide tracker: every host's gate feeds it, the
            # advisor reads the whole workload's reuse histograms
            tracker = ReuseTracker(max_classes=max(8, len(tenants) + 4),
                                   device=device)
            fetch_seconds = 0.0
            if decl.alpha_stall or any(t.slo.alpha_stall
                                       for t in tenants):
                # price the miss the way the cost model does: the
                # modeled demand-fetch time at depth 1
                fetch_seconds = SsdQueueModel.shared(sim_cfg).service(
                    decl.l_blk, 1).total

            # declared workload -> per-tenant SLO economics: each
            # tenant's alpha_stall folds into its *own* tau_be, its key
            # class is the tenant name, and its declared think gap
            # seeds the tracker prior so the very first offload is
            # priced by the declaration, not the cold default.
            # isolation="shared" is the control arm: one fleet-wide
            # threshold/class, no declared priors
            classify = None
            class_tau_be = None
            priors = dict(spec.class_priors)
            if tenants and workload.isolation == "per-tenant":
                from .workload import tenant_classifier
                classify = tenant_classifier([t.name for t in tenants])
                class_tau_be = {
                    t.name: EconomicGate.breakeven_tau(
                        host_cfg, ssd, decl.l_blk,
                        gamma_rw=decl.gamma_rw, phi_wa=decl.phi_wa,
                        alpha_stall=t.slo.alpha_stall,
                        fetch_seconds=fetch_seconds)
                    for t in tenants}
                st = spec.resolved_step_time()
                if st > 0:
                    for t in tenants:
                        priors.setdefault(t.name,
                                          t.session.gap_steps * st)
            for cls_name, interval in sorted(priors.items()):
                tracker.seed_prior(cls_name, interval)
            # fourth-tier thresholds: the pool band's upper edge (pool
            # column vs a flash re-read) gates fleet-pool admission;
            # hosts that declare a "gpu_flash" tier route gate-cold
            # admissions down the BaM path. An empty band (crossover at
            # or under tau_be) compiles to no pooling — the economics
            # say the pool's own access cost exceeds a flash IO
            tau_pool = None
            if spec.pool is not None:
                from ..core.economics import pool_flash_crossover
                base_tau = EconomicGate.breakeven_tau(
                    host_cfg, ssd, decl.l_blk, gamma_rw=decl.gamma_rw,
                    phi_wa=decl.phi_wa, alpha_stall=decl.alpha_stall,
                    fetch_seconds=fetch_seconds)
                cross = float(pool_flash_crossover(
                    host_cfg, decl.l_blk, base_tau,
                    pool_bw=spec.pool.read_bw, pool_rtt=spec.pool.rtt,
                    rent_factor=spec.pool.rent_factor,
                    alpha_net=spec.pool.alpha_net))
                if cross > base_tau:
                    tau_pool = cross
            gpu_hosts = {i for i, h in enumerate(hosts)
                         if "gpu_flash" in h.tiers}
            template_gpu = "gpu_flash" in \
                spec.hosts[spec.autoscale.template].tiers

            def factory(_h, _d=decl, _t=tracker, _f=fetch_seconds,
                        _host=host_cfg, _ssd=ssd, _c=classify,
                        _taus=class_tau_be, _tp=tau_pool,
                        _g=gpu_hosts, _n=len(hosts), _tg=template_gpu):
                kw = {} if _c is None else {"classify": _c}
                gpu = _h in _g or (_h >= _n and _tg)
                return EconomicGate.from_break_even(
                    _host, _ssd, _d.l_blk, gamma_rw=_d.gamma_rw,
                    phi_wa=_d.phi_wa, alpha_stall=_d.alpha_stall,
                    fetch_seconds=_f, tracker=_t,
                    prior_quantile=_d.prior_quantile,
                    class_tau_be=_taus, tau_pool=_tp,
                    gpu_direct=gpu, **kw)

        topology = spec.topology.compile() if spec.topology is not None \
            else None
        net_model = None
        if spec.net is not None:
            net_model = NetQueueModel(rtt=spec.net.rtt,
                                      bandwidth=spec.net.bandwidth,
                                      sat_depth=spec.net.sat_depth,
                                      topology=topology)
            topology = None         # attached to the model, per fabric rule

        obs_decl = spec.observability
        obs = Observability(trace=obs_decl.trace,
                            metrics=obs_decl.metrics,
                            max_events=obs_decl.max_events)

        pool = None
        if spec.pool is not None:
            from ..runtime.pool import PooledStore
            p = spec.pool
            pool = PooledStore(
                p.capacity_bytes, read_bw=p.read_bw,
                write_bw=p.write_bw, rtt=p.rtt, sat_depth=p.sat_depth,
                rent_factor=p.rent_factor, clock=clock, obs=obs)
        fabric = ShardedTieredStore(
            host_specs=[h.tier_specs() for h in hosts],
            weights=spec.resolved_weights(),
            policy_factory=factory, clock=clock, sim_cfg=sim_cfg,
            net_model=net_model, topology=topology,
            write_shield_depth=spec.write_shield_depth,
            vnodes=spec.vnodes, rebalance_rate=spec.rebalance_rate,
            obs=obs, pool=pool)
        if obs.metrics is not None:
            obs.metrics.register("fabric", fabric)

        if tracker is not None:
            template = spec.hosts[spec.autoscale.template]
            advisor = ProvisionAdvisor(
                host_cfg, ssd, decl.l_blk, gamma_rw=decl.gamma_rw,
                phi_wa=decl.phi_wa,
                dram_bytes_per_host=template.dram_capacity(),
                active_window=spec.autoscale.active_window)

        return cls(spec, clock, fabric, tracker=tracker, advisor=advisor,
                   step_time=spec.resolved_step_time(), obs=obs,
                   device=device)

    # -------------------------------------------------------- capabilities
    @property
    def n_hosts(self) -> int:
        return self.fabric.n_hosts

    def policy(self, host: int = 0) -> TieringPolicy:
        return self.fabric.hosts[host].policy

    def kv_session(self, rid: str, *, host: int = 0,
                   replicas: Optional[int] = None) -> KvSession:
        """Session-state capability (save/prefetch/resume one KV blob)."""
        return KvSession(self.fabric, rid, host,
                         replicas=replicas if replicas is not None
                         else self.spec.replicas)

    def expert_store(self, n_layers: int, n_experts: int, *,
                     host: int = 0, replicas: Optional[int] = None,
                     expert_bytes: float = 0.0):
        """MoE expert streaming over the fabric from `host`'s view."""
        from ..tiering.expert_store import ExpertStore
        r = replicas if replicas is not None else self.spec.replicas
        return ExpertStore(
            n_layers, n_experts, policy=self.policy(host),
            store=self.fabric.host_view(host, replicas=r),
            expert_bytes=expert_bytes)

    def checkpoint_steps(self, step_time: Optional[float] = None) -> int:
        """spec.checkpoint_interval (seconds) -> decode steps for this
        platform's step time; 0 when checkpointing is off."""
        iv = self.spec.checkpoint_interval
        if iv is None:
            return 0
        st = self.step_time if step_time is None else step_time
        if st > 0:
            return max(1, int(math.ceil(iv / st)))
        return max(1, int(round(iv)))

    def engine(self, cfg, params, *, host: int = 0,
               step_time: Optional[float] = None, **kw):
        """Decode engine on `host`'s fabric view, stepping the shared
        clock by the spec's (possibly roofline-measured) step time, on
        the platform's device unless `device=` names another. The view
        replicates puts to `spec.replicas` holders — a paused or
        checkpointed session's KV blob survives `fail_host` — and
        `spec.checkpoint_interval` arms the engine's periodic session
        checkpointing."""
        from ..serving.engine import DecodeEngine
        st = self.step_time if step_time is None else step_time
        kw.setdefault("checkpoint_interval", self.checkpoint_steps(st))
        kw.setdefault("device", self.device)
        return DecodeEngine(
            cfg, params, policy=self.policy(host),
            store=self.fabric.host_view(host,
                                        replicas=self.spec.replicas),
            step_time=st, **kw)

    def scheduler(self, cfg, params, *, host: int = 0,
                  pause_idle_steps: Optional[int] = None,
                  prefetch_lead=None, **kw):
        """Continuous-batching scheduler over a fresh engine on `host`
        (`repro_torch.serving.ContinuousScheduler`): per-step admission,
        pause-on-idle through the tiered store, prefetch-led resume.
        Knobs default to the spec's `scheduler` declaration, stall
        budgets to the declared tenants' SLOs; engine kwargs
        (`max_slots`, `max_len`, `device`, ...) pass through, and the
        engine runs on the platform's device unless `device=` names
        another."""
        from ..serving.scheduler import ContinuousScheduler
        eng = self.engine(cfg, params, host=host, **kw)
        decl = self.spec.scheduler
        budgets = {}
        if self.spec.workload is not None:
            budgets = {t.name: t.slo.p99_stall_budget
                       for t in self.spec.workload.tenants
                       if t.slo.p99_stall_budget is not None}
        return ContinuousScheduler(
            eng,
            pause_idle_steps=decl.pause_idle_steps
            if pause_idle_steps is None else pause_idle_steps,
            prefetch_lead=decl.prefetch_lead
            if prefetch_lead is None else prefetch_lead,
            stall_budgets=budgets)

    # ------------------------------------------------------------ workload
    def workload(self):
        """Compiled rendering of `spec.workload`
        (`repro_torch.platform.workload.CompiledWorkload`): tenant-tagged
        jobs, access traces, per-tenant thresholds. Cached — every
        call sees the same deterministic draw."""
        if self.spec.workload is None:
            raise ValueError(
                "spec declares no workload: set HierarchySpec.workload "
                "(a WorkloadDecl with at least one tenant) to compile "
                "scenario jobs/traces from the spec")
        if self._workload is None:
            from .workload import compile_workload
            self._workload = compile_workload(self.spec.workload)
        return self._workload

    def jobs(self, *, vocab: int = 64):
        """Declared-scenario `SessionJob` list for `self.scheduler(...)`
        — tenant-tagged, deterministic in (spec JSON, workload seed)."""
        return self.workload().jobs(vocab=vocab)

    # ---------------------------------------------------------- provision
    def advise(self, horizon: Optional[float] = None) -> ProvisionAdvice:
        """Live provisioning guidance from the fleet's measured state."""
        if self.advisor is None or self.tracker is None:
            raise ValueError(
                "platform has no advisor: provisioning guidance needs "
                "the economic policy (PolicyDecl(kind='economic')); "
                "static/factory policies track no reuse telemetry")
        return self.advisor.advise(self.tracker, fabric=self.fabric,
                                   horizon=horizon)

    def add_host(self) -> RebalanceStats:
        """Join a template host (spec.autoscale.template) and rebalance
        under the spec's pacer."""
        spec = self.spec
        template = spec.hosts[spec.autoscale.template]
        weights = spec.resolved_weights()
        first = sum(h.count for h in
                    spec.hosts[:spec.autoscale.template])
        return self.fabric.add_host(specs=template.tier_specs(),
                                    weight=weights[first])

    def fail_host(self, host: int):
        """Unplanned failure: drop `host` with no drain (see
        `ShardedTieredStore.fail_host`). Returns the `FailureReport`."""
        return self.fabric.fail_host(host)

    def repair(self, batch_keys: int = 64):
        """Re-replicate everything under-replicated or misplaced after a
        failure, paced by the spec's `rebalance_rate`. Returns
        `RepairStats` (its `duration` is the recovery time)."""
        from ..runtime.repair import RepairLoop
        return RepairLoop(self.fabric, batch_keys=batch_keys).run()

    def advise_availability(self, mttf: Optional[float] = None, **kw):
        """Replication-factor recommendation priced from live fleet
        state; `mttf` defaults to the spec's declared value."""
        if self.advisor is None:
            raise ValueError(
                "platform has no advisor: availability pricing needs "
                "the economic policy (PolicyDecl(kind='economic'))")
        mttf = self.spec.mttf if mttf is None else mttf
        if mttf is None:
            raise ValueError("no MTTF declared: set spec.mttf or pass "
                             "mttf= explicitly")
        return self.advisor.advise_availability(fabric=self.fabric,
                                                mttf=mttf, **kw)

    def advise_tiers(self, *, access_rate: float,
                     resident_bytes: Optional[float] = None, **kw):
        """Four-arm hierarchy-shape recommendation (3-tier baseline vs
        +pool vs +gpu_flash vs both) priced from the fleet's tracked
        reuse distribution. Pool parameters default to the spec's
        `PoolDecl` when one is declared; `resident_bytes` defaults to a
        live census across hosts and pool."""
        if self.advisor is None or self.tracker is None:
            raise ValueError(
                "platform has no advisor: tier-shape pricing needs "
                "the economic policy (PolicyDecl(kind='economic'))")
        p = self.spec.pool
        if p is not None:
            kw.setdefault("pool_bw", p.read_bw)
            kw.setdefault("pool_rtt", p.rtt)
            kw.setdefault("rent_factor", p.rent_factor)
            kw.setdefault("alpha_net", p.alpha_net)
        if resident_bytes is None:
            seen: Dict[object, int] = {}
            for s in self.fabric.hosts.values():
                for key in s.keys():
                    seen.setdefault(key, s.nbytes_of(key))
            if self.fabric.pool is not None:
                for key in self.fabric.pool.keys():
                    seen.setdefault(key,
                                    self.fabric.pool.nbytes_of(key))
            resident_bytes = float(sum(seen.values()))
        return self.advisor.advise_tiers(
            self.tracker, access_rate=access_rate,
            resident_bytes=resident_bytes, **kw)

    def autoscale(self, step: Optional[int] = None):
        """One closed-loop provisioning step: the advisor's host-count
        recommendation drives `add_host`/`remove_host` under the spec's
        bounds, cooldown and rebalance pacer. Returns the
        `AutoscaleDecision` (action taken, advice, rebalance stats)."""
        if self._autoscaler is None:
            from .autoscale import Autoscaler
            self._autoscaler = Autoscaler(self)
        return self._autoscaler.step(step)

    # ------------------------------------------------------------- control
    def drain(self) -> float:
        return self.fabric.drain()

    def reset_stats(self):
        """One reset for the whole platform, routed through the
        metrics registry's snapshot/reset protocol: registered
        components (fabric counters + per-host/NIC queue stats, the
        stall ledger) and every counter/gauge/histogram reset together.
        Falls back to direct resets when metrics are declared off."""
        if self.obs.metrics is not None:
            self.obs.metrics.reset()
        else:
            self.fabric.reset_stats()
            self.obs.ledger.reset_stats()

    def snapshot_stats(self) -> Dict[str, object]:
        """Uniform stats snapshot (metrics + registered components)."""
        return self.obs.snapshot_stats()

    def summary(self) -> Dict[str, float]:
        return self.fabric.summary()

    def report(self) -> str:
        return self.fabric.report()
