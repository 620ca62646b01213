"""Platform-level viability analysis and provisioning advisor (paper §V).

Combines the calibrated economics (economics.py), feasibility-capped SSD
IOPS (constraints.py) and workload thresholds (workload.py) into a single
report with an explicit verdict and an upgrade recommendation — the
"actionable provisioning guidance" the paper argues the classical rule
lacks.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from . import units
from .constraints import LatencyTargets, rho_max_for_targets, usable_iops
from .economics import CPU_DDR, GPU_GDDR, HostConfig, break_even
from .ssd_model import SsdConfig, iops_ssd_peak, storage_next_ssd
from .workload import Thresholds, thresholds


@dataclasses.dataclass(frozen=True)
class PlatformConfig:
    """A concrete host + storage deployment (paper §V-B set-up)."""

    name: str
    host: HostConfig
    ssd: SsdConfig
    n_ssd: int = 4
    b_dram_total: float = 540e9    # aggregate host-DRAM bandwidth (B/s)
    iops_proc: float = 100e6       # total host IOPS budget
    c_dram_total: Optional[float] = None  # None => capacity is a free variable


# §V-B reference platforms: 12ch DDR5-5600 (540 GB/s) / 8ch GDDR6-20 (640 GB/s)
CPU_PLATFORM = PlatformConfig(
    name="CPU+DDR", host=CPU_DDR, ssd=storage_next_ssd(),
    n_ssd=4, b_dram_total=540e9, iops_proc=100e6)
GPU_PLATFORM = PlatformConfig(
    name="GPU+GDDR", host=GPU_GDDR, ssd=storage_next_ssd(),
    n_ssd=4, b_dram_total=640e9, iops_proc=400e6)


@dataclasses.dataclass(frozen=True)
class PlatformReport:
    platform: str
    l_blk: int
    iops_ssd_peak: float        # per SSD, device physics
    rho_max: float              # latency-admissible utilization
    iops_ssd_usable: float      # per SSD after rho_max and host budget
    host_limited: bool          # host budget (not device) is the cap
    tau_break_even: float       # calibrated economics (s)
    th: Thresholds
    c_dram_viable: float        # min DRAM bytes for viability
    c_dram_optimal: float       # min DRAM bytes for economics-optimal point
    dram_bw_use_viable: float   # B_use at the viability threshold
    dram_bw_use_optimal: float
    verdict: str
    recommendation: str

    def summary(self) -> str:
        return (
            f"[{self.platform} @ {self.l_blk}B] usable "
            f"{units.human_rate(self.iops_ssd_usable)}/SSD "
            f"(rho_max={self.rho_max:.2f}"
            f"{', host-limited' if self.host_limited else ''}) | "
            f"tau_be={units.human_time(self.tau_break_even)} | "
            f"T_B={units.human_time(self.th.t_b)} "
            f"T_S={units.human_time(self.th.t_s)} "
            f"T_C={units.human_time(self.th.t_c)} | "
            f"C_viable={units.human_bytes(self.c_dram_viable)} "
            f"C_opt={units.human_bytes(self.c_dram_optimal)} | "
            f"{self.verdict}: {self.recommendation}")


def analyze_platform(platform: PlatformConfig, workload, l_blk: int,
                     targets: LatencyTargets = LatencyTargets(),
                     gamma_rw: float = 9.0,
                     phi_wa: float = 3.0) -> PlatformReport:
    """Full RQ1+RQ2+RQ3 pipeline for one platform/workload/block size."""
    ssd = platform.ssd
    peak = float(iops_ssd_peak(ssd, l_blk, gamma_rw, phi_wa))
    rho = float(rho_max_for_targets(targets, ssd.n_ch, peak,
                                    ssd.nand.tau_sense))
    per_ssd = float(usable_iops(peak, rho, platform.iops_proc,
                                platform.n_ssd))
    host_limited = platform.iops_proc / platform.n_ssd < rho * peak

    tau_be = float(break_even(platform.host, l_blk, ssd.cost, per_ssd))

    b_ssd_total = l_blk * per_ssd * platform.n_ssd
    th = thresholds(workload, platform.b_dram_total, b_ssd_total,
                    platform.c_dram_total)

    c_viable = float(workload.cached_bytes(th.t_v)) if th.t_v > 0 else 0.0
    t_o = max(tau_be, th.t_v)
    c_opt = float(workload.cached_bytes(t_o))

    bw_v = float(workload.dram_bw_use(th.t_v)) if th.t_v > 0 else \
        float(workload.dram_bw_use(1e-12))
    bw_o = float(workload.dram_bw_use(t_o))

    verdict, rec = _verdict(platform, th, tau_be, host_limited)
    return PlatformReport(
        platform=platform.name, l_blk=int(l_blk), iops_ssd_peak=peak,
        rho_max=rho, iops_ssd_usable=per_ssd, host_limited=host_limited,
        tau_break_even=tau_be, th=th, c_dram_viable=c_viable,
        c_dram_optimal=c_opt, dram_bw_use_viable=bw_v,
        dram_bw_use_optimal=bw_o, verdict=verdict, recommendation=rec)


def _verdict(platform: PlatformConfig, th: Thresholds, tau_be: float,
             host_limited: bool):
    """Paper §V-A diagnosis tree."""
    if th.t_b == float("inf"):
        return ("infeasible",
                "DRAM bandwidth below workload throughput: B_DRAM must "
                "exceed l_blk * sum(1/tau_i); upgrade memory system")
    if th.t_s == float("inf"):
        return ("infeasible",
                "storage path cannot absorb the uncached stream even with "
                "maximal caching; add SSDs or raise host IOPS")
    if not th.viable:  # only possible when c_dram_total is fixed
        if th.t_b > th.t_c >= th.t_s:
            return ("dram-bandwidth-limited", "increase B_DRAM")
        if th.t_s > th.t_c >= th.t_b:
            rec = "raise aggregate SSD throughput (more/faster SSDs)"
            if host_limited:
                rec += " — host IOPS budget is the sub-limiter; raise it first"
            return ("storage-limited", rec)
        return ("jointly-insufficient",
                "increase C_DRAM until T_C >= max(T_B,T_S), or upgrade "
                "bandwidths per price priority")
    if th.optimal(tau_be):
        return ("viable-optimal",
                "operate at tau_break_even; provision "
                f"C_DRAM = |S(tau_be)| * l_blk")
    if tau_be > th.t_c:
        return ("viable-suboptimal",
                "break-even beyond capacity threshold: add DRAM capacity to "
                "reach the economics-optimal point")
    return ("viable-suboptimal",
            "break-even below viability threshold: feasibility forces "
            "caching more than economics alone would; bandwidth upgrades "
            "(SSD/host) would reclaim the gap")
