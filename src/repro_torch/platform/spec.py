"""HierarchySpec — the declarative front door to the tiering runtime.

The paper's thesis is that tiering should fall out of a *declared*
cost/feasibility model, not hand-wired mechanism. After the runtime grew
a fabric, an autopilot and an advisor, standing up a full system still
meant threading a `VirtualClock` through five constructor dialects
(`TieredStore`, `ShardedTieredStore`, `DecodeEngine`, `ExpertStore`,
`EconomicGate`). This module replaces that with one validated spec in
the spec-then-compile style of disaggregated buffer managers:

    spec = HierarchySpec(
        hosts=[HostDecl(dram_gib=256), HostDecl(dram_gib=128, count=3)],
        policy=PolicyDecl.economic(l_blk=128 << 10),
        topology=TopologyDecl(hosts_per_rack=2),
        step_time="measured",            # roofline hook, modeled fallback
    )
    platform = Platform.compile(spec)    # repro_torch.platform.compiler

Everything in a spec is data: `to_json()`/`from_json()` round-trip
byte-exactly, so benchmarks and CI pin scenario specs instead of
constructor call sites. The one escape hatch — `policy` may be a
callable `host_id -> TieringPolicy` factory — is rejected by
`to_json()` with an actionable error, because a factory is code, not a
declaration.

Heterogeneous hosts: each `HostDecl` may carry its own tier geometry
(capacity/bandwidth skew) and the compiled fabric places ring weight
proportional to DRAM capacity (`weighting="capacity"`, the default) so
a host with 2x the DRAM owns ~2x the keys. `weighting="uniform"`
keeps the unweighted ring (the pre-heterogeneity behavior, useful as a
control arm); explicit `weights=[...]` overrides both.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Callable, Dict, List, Optional, Tuple, Union

from ..core.economics import CPU_DDR, GPU_GDDR, HostConfig
from ..core.policy import Tier, TieringPolicy
from ..core.ssd_model import NAND_TYPES, SsdConfig, storage_next_ssd
from ..runtime.tiers import TierSpec

SPEC_VERSION = 1

_TIER_NAMES = {"hbm": Tier.HBM, "dram": Tier.DRAM, "flash": Tier.FLASH,
               "gpu_flash": Tier.GPU_FLASH}
_HOST_PROFILES: Dict[str, HostConfig] = {"cpu": CPU_DDR, "gpu": GPU_GDDR}

# the TieredStore defaults (v5e-host-like HBM/DRAM + Storage-Next SSD);
# a HostDecl that omits a tier inherits the matching row. "gpu_flash"
# is intentionally absent: the BaM tier exists only when declared (its
# default geometry below mirrors the flash row — same media, different
# access path), so 3-tier hosts compile bit-identically
_DEFAULT_TIERS: Dict[str, Tuple[float, float, float]] = {
    "hbm": (16e9, 819e9, 1e-7),
    "dram": (128e9, 45e9, 5e-7),
    "flash": (4e12, 7e9, 2e-5),
}
_GPU_FLASH_DEFAULT: Tuple[float, float, float] = (4e12, 7e9, 2e-5)


def _err(path: str, msg: str) -> ValueError:
    return ValueError(f"HierarchySpec.{path}: {msg}")


@dataclasses.dataclass(frozen=True)
class TierDecl:
    """One tier's geometry on one host. `write_bw` declares an
    asymmetric write path; None inherits `read_bw` (and is omitted from
    the JSON form, so pre-existing specs stay byte-identical)."""
    capacity_bytes: float
    read_bw: float
    read_latency: float
    write_bw: Optional[float] = None

    def validate(self, path: str):
        if not self.capacity_bytes > 0:
            raise _err(path, f"capacity_bytes must be > 0 (got "
                             f"{self.capacity_bytes!r}); a zero-capacity "
                             f"tier can never hold an object")
        if not self.read_bw > 0:
            raise _err(path, f"read_bw must be > 0 B/s (got "
                             f"{self.read_bw!r})")
        if self.read_latency < 0:
            raise _err(path, f"read_latency must be >= 0 s (got "
                             f"{self.read_latency!r})")
        if self.write_bw is not None and not self.write_bw > 0:
            raise _err(path, f"write_bw must be > 0 B/s when given "
                             f"(got {self.write_bw!r}); omit it to "
                             f"inherit read_bw")


def gpu_flash_tier(**kw) -> TierDecl:
    """A BaM-style GPU-direct flash tier at the default flash geometry
    (same media as the host flash row, different access path); override
    any field via keywords."""
    cap, bw, lat = _GPU_FLASH_DEFAULT
    return TierDecl(**{**dict(capacity_bytes=cap, read_bw=bw,
                              read_latency=lat), **kw})


@dataclasses.dataclass(frozen=True)
class HostDecl:
    """One host class: its tier geometry, ring weight and multiplicity.

    `tiers` maps "hbm"/"dram"/"flash" to a `TierDecl`; omitted tiers
    inherit the runtime defaults. `count` expands the declaration into
    that many identical hosts. `weight` overrides the capacity-derived
    ring weight for these hosts."""
    tiers: Dict[str, TierDecl] = dataclasses.field(default_factory=dict)
    weight: Optional[float] = None
    count: int = 1

    def validate(self, path: str):
        if self.count < 1:
            raise _err(path, f"count must be >= 1 (got {self.count})")
        if self.weight is not None and not self.weight > 0:
            raise _err(path, f"weight must be > 0 (got {self.weight!r})")
        for name, tier in self.tiers.items():
            if name not in _TIER_NAMES:
                raise _err(f"{path}.tiers", f"unknown tier {name!r}; one "
                           f"of {sorted(_TIER_NAMES)}")
            tier.validate(f"{path}.tiers[{name!r}]")

    def dram_capacity(self) -> float:
        decl = self.tiers.get("dram")
        return decl.capacity_bytes if decl is not None \
            else _DEFAULT_TIERS["dram"][0]

    def tier_specs(self) -> Optional[Dict[Tier, TierSpec]]:
        """Compiled per-host TierSpec dict; None when fully default.
        The three base tiers always compile (omitted ones inherit the
        defaults); "gpu_flash" compiles only when declared — a store
        never grows the BaM lane implicitly."""
        if not self.tiers:
            return None
        out: Dict[Tier, TierSpec] = {}
        for name, (cap, bw, lat) in _DEFAULT_TIERS.items():
            decl = self.tiers.get(name)
            wbw = None
            if decl is not None:
                cap, bw, lat, wbw = (decl.capacity_bytes, decl.read_bw,
                                     decl.read_latency, decl.write_bw)
            out[_TIER_NAMES[name]] = TierSpec(cap, bw, lat, write_bw=wbw)
        decl = self.tiers.get("gpu_flash")
        if decl is not None:
            out[Tier.GPU_FLASH] = TierSpec(
                decl.capacity_bytes, decl.read_bw, decl.read_latency,
                write_bw=decl.write_bw)
        return out


@dataclasses.dataclass(frozen=True)
class PolicyDecl:
    """Declarative placement policy.

    kind="static": a plain `TieringPolicy` with pinned thresholds on
    every host. kind="economic": a per-host `EconomicGate` priced from
    the calibrated break-even economics (`host_profile` x `nand` x
    `l_blk`), all gates sharing one fleet-wide `ReuseTracker` so the
    advisor sees the whole workload."""
    kind: str = "economic"
    # static thresholds
    tau_hot: Optional[float] = None
    tau_be: Optional[float] = None
    ema_alpha: float = 0.2
    hysteresis: float = 0.25
    # economic calibration
    host_profile: str = "gpu"
    nand: str = "slc"
    l_blk: int = 128 << 10
    alpha_stall: float = 0.0
    gamma_rw: float = 9.0
    phi_wa: float = 3.0
    prior_quantile: float = 0.5

    KINDS = ("economic", "static")

    def validate(self, path: str = "policy"):
        if self.kind not in self.KINDS:
            raise _err(path, f"unknown policy kind {self.kind!r}; one of "
                             f"{self.KINDS} (or pass a callable "
                             f"host_id -> TieringPolicy factory)")
        if self.kind == "static":
            if self.tau_hot is None or self.tau_be is None:
                raise _err(path, "static policy needs explicit tau_hot "
                                 "and tau_be thresholds")
            if self.tau_hot > self.tau_be:
                raise _err(path, f"tau_hot={self.tau_hot} must be <= "
                                 f"tau_be={self.tau_be}")
        else:
            if self.host_profile not in _HOST_PROFILES:
                raise _err(path, f"unknown host_profile "
                           f"{self.host_profile!r}; one of "
                           f"{sorted(_HOST_PROFILES)}")
            if self.nand not in NAND_TYPES:
                raise _err(path, f"unknown nand {self.nand!r}; one of "
                           f"{sorted(NAND_TYPES)}")
            if self.l_blk < 1:
                raise _err(path, f"l_blk must be >= 1 byte "
                                 f"(got {self.l_blk})")

    # ------------------------------------------------------- constructors
    @classmethod
    def static(cls, tau_hot: float, tau_be: float, **kw) -> "PolicyDecl":
        return cls(kind="static", tau_hot=tau_hot, tau_be=tau_be, **kw)

    @classmethod
    def pinned_flash(cls) -> "PolicyDecl":
        """Everything stays on flash — the restore-path benchmark policy."""
        return cls.static(tau_hot=1e-12, tau_be=1e-9, ema_alpha=1.0)

    @classmethod
    def pinned_dram(cls) -> "PolicyDecl":
        """Everything wants DRAM; only capacity pressure demotes."""
        return cls.static(tau_hot=1e-12, tau_be=1e12)

    @classmethod
    def economic(cls, **kw) -> "PolicyDecl":
        return cls(kind="economic", **kw)

    # ----------------------------------------------------------- compile
    def economics(self) -> Tuple[HostConfig, SsdConfig]:
        return (_HOST_PROFILES[self.host_profile],
                storage_next_ssd(NAND_TYPES[self.nand]))


@dataclasses.dataclass(frozen=True)
class PoolDecl:
    """The fleet-shared disaggregated far-memory pool
    (`runtime.pool.PooledStore`): one DRAM-class slab every host
    reaches over a per-host RTT lane, rented at `rent_factor` of the
    local DRAM rate (statistical multiplexing of uncorrelated per-host
    peaks pays the discount). The compiler wires the pool into the
    fabric (gate-admitted between local-DRAM miss and remote-flash
    fetch) and prices its Eq. 1 column from these numbers."""
    capacity_bytes: float
    read_bw: float = 40e9
    write_bw: Optional[float] = None
    rtt: float = 2e-6
    sat_depth: int = 4
    rent_factor: float = 0.5
    alpha_net: float = 2.0

    def validate(self, path: str = "pool"):
        if not self.capacity_bytes > 0:
            raise _err(path, f"capacity_bytes must be > 0 (got "
                             f"{self.capacity_bytes!r})")
        if not self.read_bw > 0:
            raise _err(path, f"read_bw must be > 0 B/s (got "
                             f"{self.read_bw!r})")
        if self.write_bw is not None and not self.write_bw > 0:
            raise _err(path, f"write_bw must be > 0 B/s when given "
                             f"(got {self.write_bw!r}); omit it to "
                             f"inherit read_bw")
        if self.rtt < 0:
            raise _err(path, f"rtt must be >= 0 s (got {self.rtt!r})")
        if self.sat_depth < 1:
            raise _err(path, f"sat_depth must be >= 1 (got "
                             f"{self.sat_depth})")
        if not 0.0 < self.rent_factor < 1.0:
            raise _err(path, f"rent_factor must be in (0, 1) (got "
                             f"{self.rent_factor!r}): 0 rents the pool "
                             f"for free, 1 at the full local-DRAM rate "
                             f"— neither is a pool")
        if self.alpha_net <= 0:
            raise _err(path, f"alpha_net must be positive (got "
                             f"{self.alpha_net!r})")


@dataclasses.dataclass(frozen=True)
class TopologyDecl:
    """Rack/spine descriptor, compiled to `runtime.service.FabricTopology`."""
    hosts_per_rack: int = 4
    rack_rtt: float = 15e-6
    spine_rtt: float = 40e-6
    rack_bandwidth: float = 12.5e9
    spine_bandwidth: float = 6.25e9
    incast_degree: int = 2

    def validate(self, path: str = "topology"):
        try:
            self.compile()
        except ValueError as e:
            raise _err(path, str(e)) from e

    def compile(self):
        from ..runtime.service import FabricTopology
        return FabricTopology(**dataclasses.asdict(self))


@dataclasses.dataclass(frozen=True)
class NetDecl:
    """Uniform NIC-link parameters (`runtime.service.NetQueueModel`)."""
    rtt: float = 25e-6
    bandwidth: float = 12.5e9
    sat_depth: int = 4

    def validate(self, path: str = "net"):
        if self.rtt < 0 or self.bandwidth <= 0 or self.sat_depth < 1:
            raise _err(path, f"invalid NIC parameters "
                             f"{dataclasses.asdict(self)}")


@dataclasses.dataclass(frozen=True)
class AutoscaleDecl:
    """Closed provisioning loop: bounds and pacing for
    `Platform.autoscale` (advisor-driven `add_host`/`remove_host`)."""
    min_hosts: int = 1
    max_hosts: int = 8
    cooldown_steps: int = 8
    template: int = 0           # index into spec.hosts for new hosts
    active_window: Optional[float] = None   # advisor hot-set staleness (s)

    def validate(self, path: str = "autoscale"):
        if self.min_hosts < 1:
            raise _err(path, f"min_hosts must be >= 1 (got "
                             f"{self.min_hosts})")
        if self.max_hosts < self.min_hosts:
            raise _err(path, f"max_hosts={self.max_hosts} < "
                             f"min_hosts={self.min_hosts}")
        if self.cooldown_steps < 0:
            raise _err(path, "cooldown_steps must be >= 0")
        if self.active_window is not None and self.active_window <= 0:
            raise _err(path, "active_window must be positive seconds")


@dataclasses.dataclass(frozen=True)
class SchedulerDecl:
    """Continuous-batching scheduler knobs
    (`repro_torch.serving.ContinuousScheduler`, built via
    `Platform.scheduler`).

    `pause_idle_steps`: inter-turn gaps of at most this many decode
    steps keep a session *parked* in its slot (resident, not decoding);
    longer gaps offload the KV through the tiered store — the paper's
    break-even decision point. 0 always offloads.
    `prefetch_lead`: "p99" sizes each paused session's restore prefetch
    from the serving tier's calibrated tail latency; an integer is a
    fixed lead in decode steps; 0 disables prefetch."""
    pause_idle_steps: int = 0
    prefetch_lead: Union[int, str] = "p99"

    def validate(self, path: str = "scheduler"):
        if self.pause_idle_steps < 0:
            raise _err(path, f"pause_idle_steps must be >= 0 (got "
                             f"{self.pause_idle_steps})")
        if isinstance(self.prefetch_lead, str):
            if self.prefetch_lead != "p99":
                raise _err(path, f"prefetch_lead must be 'p99' or a "
                           f"step count (got {self.prefetch_lead!r})")
        elif self.prefetch_lead < 0:
            raise _err(path, f"prefetch_lead must be >= 0 steps (got "
                             f"{self.prefetch_lead})")


@dataclasses.dataclass(frozen=True)
class ObservabilityDecl:
    """Observability plane knobs (`repro_torch.obs.Observability`, attached
    by `Platform.compile`).

    `metrics` keeps the array-backed `MetricsRegistry` on (counters,
    gauges, log-bucket histograms; cheap enough for the 1M-key replay).
    `trace` turns on the causal `Tracer` — Perfetto/Chrome trace_event
    export of the full request lifecycle on the modeled clock — capped
    at `max_events` non-metadata events. The Eq. 1 stall ledger is
    *not* declared here: it is always on."""
    trace: bool = False
    metrics: bool = True
    max_events: int = 200_000

    def validate(self, path: str = "observability"):
        if self.max_events < 1:
            raise _err(path, f"max_events must be >= 1 (got "
                             f"{self.max_events})")


@dataclasses.dataclass(frozen=True)
class ArrivalDecl:
    """When a tenant's sessions (and background objects) show up.

    `kind` shapes a per-step arrival intensity over the workload
    horizon: "stationary" is flat, "scan_flood" is a low baseline with
    periodic full-rate bursts (`period`/`burst_len`), "diurnal" is a
    raised-cosine day curve (`period` = one day in steps), and
    "flash_crowd" is a low baseline with one spike of `burst_len` steps
    centered on `peak_step` (default mid-horizon). Session start steps
    are drawn from the normalized intensity; `background_per_step`
    objects per step (scaled by the same intensity) model side traffic —
    drawn zipf-`background_zipf` from a `background_pool` keyspace, or
    fresh one-touch keys when the pool is 0 (the scan shape)."""
    kind: str = "stationary"
    period: int = 48
    burst_len: int = 8
    peak_step: Optional[int] = None
    baseline: float = 0.1
    background_per_step: int = 0
    background_pool: int = 0
    background_zipf: float = 3.0

    KINDS = ("stationary", "scan_flood", "diurnal", "flash_crowd")

    def validate(self, path: str):
        if self.kind not in self.KINDS:
            raise _err(path, f"unknown arrival kind {self.kind!r}; one "
                             f"of {self.KINDS}")
        if self.period < 1 or self.burst_len < 1:
            raise _err(path, f"period/burst_len must be >= 1 step (got "
                             f"{self.period}/{self.burst_len})")
        if self.peak_step is not None and self.peak_step < 0:
            raise _err(path, "peak_step must be >= 0")
        if not 0.0 <= self.baseline <= 1.0:
            raise _err(path, f"baseline must be in [0, 1] (got "
                             f"{self.baseline!r})")
        if self.background_per_step < 0 or self.background_pool < 0:
            raise _err(path, "background_per_step/background_pool must "
                             "be >= 0")
        if self.background_zipf <= 0:
            raise _err(path, "background_zipf must be positive")

    def intensity(self, n_steps: int) -> "np.ndarray":
        """Per-step arrival mass over `n_steps`, values in (0, 1]."""
        import numpy as np
        t = np.arange(n_steps)
        if self.kind == "stationary":
            return np.ones(n_steps)
        if self.kind == "scan_flood":
            mass = np.full(n_steps, self.baseline)
            mass[(t % self.period) < self.burst_len] = 1.0
            return mass
        if self.kind == "diurnal":
            day = 0.5 - 0.5 * np.cos(2 * np.pi * t / max(self.period, 1))
            return self.baseline + (1.0 - self.baseline) * day
        # flash_crowd
        peak = self.peak_step if self.peak_step is not None \
            else n_steps // 2
        mass = np.full(n_steps, self.baseline)
        half = self.burst_len // 2
        mass[max(0, peak - half):peak + self.burst_len - half] = 1.0
        return mass


@dataclasses.dataclass(frozen=True)
class SessionShapeDecl:
    """One session class: turn count, token/prompt shape and think-time.

    `gap_steps` is the declared mean inter-turn think gap in decode
    steps (jittered by `gap_jitter`); it doubles as the tenant's
    declared reuse interval, which `Platform.compile` seeds into the
    `ReuseTracker` prior so a tenant's very first KV offload is priced
    from its declaration instead of the cold default.
    `extra_keys_per_turn` models per-turn side reads (RAG corpus
    lookups when `extra_key_pool` > 0, fresh scan keys when 0)."""
    n_turns: int = 3
    tokens_per_turn: int = 6
    prompt_len: int = 5
    gap_steps: int = 4
    gap_jitter: float = 0.5
    extra_keys_per_turn: int = 0
    extra_key_pool: int = 0
    extra_zipf: float = 1.5

    def validate(self, path: str):
        if self.n_turns < 1:
            raise _err(path, f"n_turns must be >= 1 (got {self.n_turns})")
        if self.tokens_per_turn < 1:
            raise _err(path, f"tokens_per_turn must be >= 1 (got "
                             f"{self.tokens_per_turn})")
        if self.prompt_len < 1:
            raise _err(path, f"prompt_len must be >= 1 (got "
                             f"{self.prompt_len})")
        if self.gap_steps < 1:
            raise _err(path, f"gap_steps must be >= 1 (got "
                             f"{self.gap_steps})")
        if not 0.0 <= self.gap_jitter < 1.0:
            raise _err(path, f"gap_jitter must be in [0, 1) (got "
                             f"{self.gap_jitter!r})")
        if self.extra_keys_per_turn < 0 or self.extra_key_pool < 0:
            raise _err(path, "extra_keys_per_turn/extra_key_pool must "
                             "be >= 0")
        if self.extra_zipf <= 0:
            raise _err(path, "extra_zipf must be positive")

    # ------------------------------------------------- session-class presets
    @classmethod
    def chat(cls, **kw) -> "SessionShapeDecl":
        """Interactive multi-turn chat: short gaps, modest tokens."""
        return cls(**{**dict(n_turns=3, tokens_per_turn=6, prompt_len=5,
                             gap_steps=3), **kw})

    @classmethod
    def rag(cls, **kw) -> "SessionShapeDecl":
        """Retrieval-augmented: long prompts + per-turn corpus reads."""
        return cls(**{**dict(n_turns=2, tokens_per_turn=8, prompt_len=12,
                             gap_steps=5, extra_keys_per_turn=4,
                             extra_key_pool=256), **kw})

    @classmethod
    def moe_heavy(cls, **kw) -> "SessionShapeDecl":
        """Expert-heavy decode: long generations, sparse turns."""
        return cls(**{**dict(n_turns=2, tokens_per_turn=16, prompt_len=6,
                             gap_steps=8), **kw})

    @classmethod
    def scan(cls, **kw) -> "SessionShapeDecl":
        """Scan adversary: short decodes, long think gaps, a stream of
        fresh one-touch side keys."""
        return cls(**{**dict(n_turns=2, tokens_per_turn=2, prompt_len=3,
                             gap_steps=24, gap_jitter=0.25,
                             extra_keys_per_turn=8, extra_key_pool=0),
                      **kw})


@dataclasses.dataclass(frozen=True)
class SloDecl:
    """Per-tenant service objective, priced into the gate.

    `alpha_stall` is the paper's stalled-engine rent multiplier: it is
    folded into this tenant's *own* `tau_be` via
    `EconomicGate.from_break_even`, so a premium tenant's stall rents
    DRAM harder than a batch tenant's. `deadline_steps` bounds turn
    admission lateness; `p99_stall_budget` (seconds of stall per
    generated token, p99 across the tenant's sessions) is the isolation
    assertion's budget — None declares no budget."""
    deadline_steps: int = 8
    p99_stall_budget: Optional[float] = None
    alpha_stall: float = 0.0

    def validate(self, path: str):
        if self.deadline_steps < 0:
            raise _err(path, f"deadline_steps must be >= 0 (got "
                             f"{self.deadline_steps})")
        if self.p99_stall_budget is not None \
                and self.p99_stall_budget <= 0:
            raise _err(path, "p99_stall_budget must be positive seconds "
                             "per token (omit it to declare no budget)")
        if self.alpha_stall < 0:
            raise _err(path, f"alpha_stall must be >= 0 (got "
                             f"{self.alpha_stall!r})")


@dataclasses.dataclass(frozen=True)
class TenantDecl:
    """One tenant: a named session population with an arrival process
    and an SLO. The tenant name becomes the reuse-tracking class for
    its KV keys (session ids are `"{name}/NNN"`), so priors, quantiles
    and gate thresholds are all per-tenant."""
    name: str
    n_sessions: int = 4
    session: SessionShapeDecl = SessionShapeDecl()
    arrival: ArrivalDecl = ArrivalDecl()
    slo: SloDecl = SloDecl()

    def validate(self, path: str):
        if not self.name or "/" in self.name:
            raise _err(path, f"tenant name must be a non-empty string "
                             f"without '/' (got {self.name!r}); '/' "
                             f"separates the tenant from the session id")
        if self.n_sessions < 0:
            raise _err(path, f"n_sessions must be >= 0 (got "
                             f"{self.n_sessions})")
        self.session.validate(f"{path}.session")
        self.arrival.validate(f"{path}.arrival")
        self.slo.validate(f"{path}.slo")


@dataclasses.dataclass(frozen=True)
class WorkloadDecl:
    """A declared multi-tenant scenario: who arrives when, with what
    session shape, under which SLO. `platform.workload.compile_workload`
    compiles it into deterministic `SessionJob` lists for the continuous
    scheduler, access traces for the autopilot benches, and per-tenant
    `EconomicGate` thresholds — one JSON artifact end-to-end.

    `isolation="per-tenant"` gives every tenant its own tau_be (its
    `alpha_stall` folded in) and seeds its declared reuse prior;
    `"shared"` compiles the pack against one fleet-wide threshold and
    class (the pre-WorkloadDecl behavior — the control arm the
    isolation benchmark compares against)."""
    tenants: Tuple[TenantDecl, ...] = ()
    horizon_steps: int = 96
    seed: int = 0
    isolation: str = "per-tenant"

    ISOLATION = ("per-tenant", "shared")

    def __post_init__(self):
        if isinstance(self.tenants, list):
            object.__setattr__(self, "tenants", tuple(self.tenants))

    def validate(self, path: str = "workload"):
        if not self.tenants:
            raise _err(f"{path}.tenants", "need at least one tenant")
        names = [t.name for t in self.tenants]
        if len(set(names)) != len(names):
            raise _err(f"{path}.tenants", f"tenant names must be unique "
                       f"(got {names})")
        for i, t in enumerate(self.tenants):
            if not isinstance(t, TenantDecl):
                raise _err(f"{path}.tenants[{i}]", f"expected TenantDecl,"
                           f" got {type(t).__name__}")
            t.validate(f"{path}.tenants[{i}]")
        if self.horizon_steps < 1:
            raise _err(f"{path}.horizon_steps", f"must be >= 1 (got "
                       f"{self.horizon_steps})")
        if self.isolation not in self.ISOLATION:
            raise _err(f"{path}.isolation", f"unknown mode "
                       f"{self.isolation!r}; one of {self.ISOLATION}")

    @staticmethod
    def from_dict(d: Dict) -> "WorkloadDecl":
        """Reconstruct from a JSON-decoded dict (nested decls included)."""
        tenants = tuple(
            TenantDecl(name=t["name"],
                       n_sessions=t.get("n_sessions", 4),
                       session=SessionShapeDecl(**t.get("session", {})),
                       arrival=ArrivalDecl(**t.get("arrival", {})),
                       slo=SloDecl(**t.get("slo", {})))
            for t in d.get("tenants", []))
        return WorkloadDecl(
            tenants=tenants,
            horizon_steps=d.get("horizon_steps", 96),
            seed=d.get("seed", 0),
            isolation=d.get("isolation", "per-tenant"))


PolicyLike = Union[PolicyDecl, Callable[[int], TieringPolicy]]


@dataclasses.dataclass(frozen=True)
class HierarchySpec:
    """The whole platform, declared: hosts (possibly heterogeneous),
    fabric topology, policy, workload priors and clock source. Compile
    with `repro_torch.platform.Platform.compile`."""
    hosts: Tuple[HostDecl, ...] = (HostDecl(),)
    policy: PolicyLike = PolicyDecl()
    weighting: str = "capacity"             # capacity | uniform
    weights: Optional[Tuple[float, ...]] = None
    topology: Optional[TopologyDecl] = None
    net: Optional[NetDecl] = None
    pool: Optional[PoolDecl] = None
    clock: str = "virtual"                  # virtual | wall
    t0: float = 0.0
    step_time: Union[float, str] = 0.0      # seconds | "measured"
    step_time_fallback: float = 2e-3
    roofline_arch: Optional[str] = None
    roofline_shape: str = "decode_32k"
    roofline_results: Optional[str] = None  # results dir override
    class_priors: Dict[str, float] = dataclasses.field(
        default_factory=dict)               # class -> assumed interval (s)
    replicas: int = 1
    vnodes: int = 64
    write_shield_depth: Optional[int] = None
    rebalance_rate: Optional[float] = None
    mttf: Optional[float] = None            # seconds/host (availability)
    checkpoint_interval: Optional[float] = None     # seconds between
    #                                 engine session checkpoints (None=off)
    autoscale: AutoscaleDecl = AutoscaleDecl()
    scheduler: SchedulerDecl = SchedulerDecl()
    observability: ObservabilityDecl = ObservabilityDecl()
    workload: Optional[WorkloadDecl] = None

    def __post_init__(self):
        # normalize list inputs (JSON round-trip hands us lists)
        if isinstance(self.hosts, list):
            object.__setattr__(self, "hosts", tuple(self.hosts))
        if isinstance(self.weights, list):
            object.__setattr__(self, "weights", tuple(self.weights))

    # ----------------------------------------------------------- validate
    def validate(self) -> "HierarchySpec":
        if not self.hosts:
            raise _err("hosts", "need at least one host declaration")
        for i, h in enumerate(self.hosts):
            if not isinstance(h, HostDecl):
                raise _err(f"hosts[{i}]", f"expected HostDecl, got "
                                          f"{type(h).__name__}")
            h.validate(f"hosts[{i}]")
        if callable(self.policy):
            pass                        # programmatic factory, trusted
        elif isinstance(self.policy, PolicyDecl):
            self.policy.validate()
        else:
            raise _err("policy", f"expected PolicyDecl or a callable "
                       f"host_id -> TieringPolicy factory, got "
                       f"{type(self.policy).__name__}")
        if self.weighting not in ("capacity", "uniform"):
            raise _err("weighting", f"unknown weighting "
                       f"{self.weighting!r}; one of ('capacity', "
                       f"'uniform')")
        if self.weights is not None:
            if len(self.weights) != self.n_hosts:
                raise _err("weights", f"{len(self.weights)} ring weights "
                           f"for {self.n_hosts} hosts; lengths must "
                           f"match")
            if any(not w > 0 for w in self.weights):
                raise _err("weights", "ring weights must be positive")
        if self.topology is not None:
            self.topology.validate()
        if self.net is not None:
            self.net.validate()
        if self.pool is not None:
            if not isinstance(self.pool, PoolDecl):
                raise _err("pool", f"expected PoolDecl, got "
                                   f"{type(self.pool).__name__}")
            self.pool.validate()
        if self.clock not in ("virtual", "wall"):
            raise _err("clock", f"unknown clock source {self.clock!r}; "
                       f"one of ('virtual', 'wall')")
        if isinstance(self.step_time, str):
            if self.step_time != "measured":
                raise _err("step_time", f"expected seconds or "
                           f"'measured', got {self.step_time!r}")
        elif self.step_time < 0:
            raise _err("step_time", "step_time must be >= 0 seconds")
        if self.step_time_fallback < 0:
            raise _err("step_time_fallback", "must be >= 0 seconds")
        for cls, iv in self.class_priors.items():
            if not iv > 0:
                raise _err(f"class_priors[{cls!r}]",
                           f"prior interval must be positive seconds "
                           f"(got {iv!r})")
        if self.replicas < 1:
            raise _err("replicas", f"must be >= 1 (got {self.replicas})")
        if self.vnodes < 1:
            raise _err("vnodes", f"must be >= 1 (got {self.vnodes})")
        if self.write_shield_depth is not None \
                and self.write_shield_depth < 1:
            raise _err("write_shield_depth", "must be >= 1 (a zero "
                       "threshold would shield forever)")
        if self.rebalance_rate is not None and self.rebalance_rate <= 0:
            raise _err("rebalance_rate", "must be positive bytes/s")
        if self.mttf is not None and self.mttf <= 0:
            raise _err("mttf", "must be positive seconds per host")
        if self.checkpoint_interval is not None \
                and self.checkpoint_interval <= 0:
            raise _err("checkpoint_interval", "must be positive seconds "
                       "(omit it to disable checkpointing)")
        self.autoscale.validate()
        self.scheduler.validate()
        self.observability.validate()
        if self.workload is not None:
            if not isinstance(self.workload, WorkloadDecl):
                raise _err("workload", f"expected WorkloadDecl, got "
                                       f"{type(self.workload).__name__}")
            self.workload.validate()
        if not 0 <= self.autoscale.template < len(self.hosts):
            raise _err("autoscale.template", f"host index "
                       f"{self.autoscale.template} out of range for "
                       f"{len(self.hosts)} host declaration(s)")
        return self

    # ------------------------------------------------------------ derived
    @property
    def n_hosts(self) -> int:
        return sum(h.count for h in self.hosts)

    def expanded_hosts(self) -> List[HostDecl]:
        """One entry per physical host (counts unrolled)."""
        out: List[HostDecl] = []
        for h in self.hosts:
            out.extend([h] * h.count)
        return out

    def resolved_weights(self) -> List[float]:
        """Ring weight per physical host: explicit `weights` list, else
        per-host `weight` overrides on top of the weighting mode
        (capacity: DRAM capacity normalized so the smallest host is 1.0
        — homogeneous fleets reproduce the unweighted ring exactly;
        uniform: all 1.0)."""
        hosts = self.expanded_hosts()
        if self.weights is not None:
            return [float(w) for w in self.weights]
        if self.weighting == "uniform":
            base = [1.0] * len(hosts)
        else:
            caps = [h.dram_capacity() for h in hosts]
            lo = min(caps)
            base = [c / lo for c in caps]
        return [h.weight if h.weight is not None else w
                for h, w in zip(hosts, base)]

    def resolved_step_time(self) -> float:
        """Seconds of modeled decode compute per step; `"measured"`
        resolves through the roofline hook (falling back to
        `step_time_fallback` off-hardware)."""
        if self.step_time == "measured":
            from .roofline_hook import measured_step_time
            t = measured_step_time(arch=self.roofline_arch,
                                   shape=self.roofline_shape,
                                   results_dir=self.roofline_results)
            return float(t) if t is not None else self.step_time_fallback
        return float(self.step_time)

    # --------------------------------------------------------------- json
    def to_json(self, indent: Optional[int] = None) -> str:
        """Serialize; byte-stable (sorted keys) so CI can pin specs.
        Raises for a callable policy — a factory is code, not data."""
        if callable(self.policy) and not isinstance(self.policy,
                                                    PolicyDecl):
            raise ValueError(
                "HierarchySpec.policy is a callable factory and cannot "
                "be serialized; declare it as a PolicyDecl (kind="
                "'economic' or 'static') to make the spec round-trip")
        d = dataclasses.asdict(self)
        d["version"] = SPEC_VERSION
        # inherit-markers are omitted, not serialized as null, so specs
        # written before the field existed stay byte-identical
        if d.get("pool") is None:
            d.pop("pool", None)
        for h in d.get("hosts", []):
            for t in h.get("tiers", {}).values():
                if t.get("write_bw") is None:
                    t.pop("write_bw", None)
        return json.dumps(d, sort_keys=True, indent=indent)

    @classmethod
    def from_json(cls, blob: str) -> "HierarchySpec":
        """Parse + validate; `from_json(to_json(spec)) == spec`."""
        try:
            d = json.loads(blob)
        except json.JSONDecodeError as e:
            raise ValueError(f"HierarchySpec JSON is not valid JSON: "
                             f"{e}") from e
        if not isinstance(d, dict):
            raise ValueError("HierarchySpec JSON must be an object")
        version = d.pop("version", SPEC_VERSION)
        if version != SPEC_VERSION:
            raise ValueError(f"HierarchySpec version {version} not "
                             f"supported (this build reads "
                             f"{SPEC_VERSION})")
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(d) - known)
        if unknown:
            raise ValueError(f"HierarchySpec JSON has unknown fields "
                             f"{unknown}; known fields are "
                             f"{sorted(known)}")
        hosts = tuple(
            HostDecl(tiers={name: TierDecl(**t)
                            for name, t in h.get("tiers", {}).items()},
                     weight=h.get("weight"), count=h.get("count", 1))
            for h in d.pop("hosts", [{}]))
        policy = d.pop("policy", None)
        policy = PolicyDecl(**policy) if policy is not None \
            else PolicyDecl()
        topology = d.pop("topology", None)
        topology = TopologyDecl(**topology) if topology is not None \
            else None
        net = d.pop("net", None)
        net = NetDecl(**net) if net is not None else None
        pool = d.pop("pool", None)
        pool = PoolDecl(**pool) if pool is not None else None
        autoscale = d.pop("autoscale", None)
        autoscale = AutoscaleDecl(**autoscale) if autoscale is not None \
            else AutoscaleDecl()
        scheduler = d.pop("scheduler", None)
        scheduler = SchedulerDecl(**scheduler) if scheduler is not None \
            else SchedulerDecl()
        observability = d.pop("observability", None)
        observability = ObservabilityDecl(**observability) \
            if observability is not None else ObservabilityDecl()
        workload = d.pop("workload", None)
        workload = WorkloadDecl.from_dict(workload) \
            if workload is not None else None
        weights = d.pop("weights", None)
        spec = cls(hosts=hosts, policy=policy, topology=topology,
                   net=net, pool=pool, autoscale=autoscale,
                   scheduler=scheduler, observability=observability,
                   workload=workload,
                   weights=tuple(weights) if weights is not None
                   else None, **d)
        return spec.validate()
