"""MQSim-Next — a calibrated Storage-Next SSD simulator (paper §VI).

A numpy discrete-event model; see `engine` for the mechanisms. It
calibrates the flash tier's queue-depth-dependent service times
(`runtime.service.SsdQueueModel`).
"""
from .config import SimConfig
from .engine import SimResult, simulate, simulate_peak_iops, simulate_latency

__all__ = ["SimConfig", "SimResult", "simulate", "simulate_peak_iops",
           "simulate_latency"]
