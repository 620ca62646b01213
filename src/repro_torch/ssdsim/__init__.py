"""MQSim-Next — a calibrated Storage-Next SSD simulator (paper §VI).

A numpy discrete-event model; see `engine` for the mechanisms. It
calibrates the flash tier's queue-depth-dependent service times
(`runtime.service.SsdQueueModel`). `analytic_iops_grid` sweeps the
analytic model over a (block size x read:write ratio) grid on a device.
"""
from .config import SimConfig
from .engine import SimResult, simulate, simulate_peak_iops, simulate_latency
from .sweep import analytic_iops_grid

__all__ = ["SimConfig", "SimResult", "simulate", "simulate_peak_iops",
           "simulate_latency", "analytic_iops_grid"]
