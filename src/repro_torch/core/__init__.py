"""repro_torch.core — the paper's contribution: a calibrated, constraint-
and workload-aware reformulation of the five-minute rule (RQ1-RQ3).

Analytics run in float64: every function converts its inputs with an
explicit `torch.float64` (the global default dtype is never changed).
"""
from . import units
from .ssd_model import (
    NandConfig, SsdConfig, SLC, PSLC, TLC, NAND_TYPES,
    storage_next_ssd, normal_ssd, iops_ssd_peak, iops_dev_peak,
    rw_fractions, gamma_from_mix, bottleneck,
)
from .economics import (
    HostConfig, CPU_DDR, GPU_GDDR, break_even, break_even_components,
    classical_break_even,
)
from .constraints import (
    mean_read_latency, tail_read_latency, rho_max_for_targets, usable_iops,
    LatencyTargets,
)
from .workload import (
    LogNormalWorkload, EmpiricalWorkload, thresholds, Thresholds,
)
from .platform import (
    PlatformConfig, CPU_PLATFORM, GPU_PLATFORM, analyze_platform,
    PlatformReport,
)
from .policy import TieringPolicy, Tier

__all__ = [
    "units", "NandConfig", "SsdConfig", "SLC", "PSLC", "TLC", "NAND_TYPES",
    "storage_next_ssd", "normal_ssd", "iops_ssd_peak", "iops_dev_peak",
    "rw_fractions", "gamma_from_mix", "bottleneck",
    "HostConfig", "CPU_DDR", "GPU_GDDR", "break_even",
    "break_even_components", "classical_break_even",
    "mean_read_latency", "tail_read_latency", "rho_max_for_targets",
    "usable_iops", "LatencyTargets",
    "LogNormalWorkload", "EmpiricalWorkload", "thresholds", "Thresholds",
    "PlatformConfig", "CPU_PLATFORM", "GPU_PLATFORM", "analyze_platform",
    "PlatformReport", "TieringPolicy", "Tier",
]
