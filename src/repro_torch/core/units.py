"""Unit helpers and hardware constants used across the port.

All cost terms are normalized to the cost of one NAND die (= 1.0), following
the paper's Table III normalization.  All times are seconds, sizes bytes,
rates per-second.
"""
from __future__ import annotations

# ---- sizes ----------------------------------------------------------------
KiB = 1024
MiB = 1024 * KiB
GiB = 1024 * MiB
TiB = 1024 * GiB

KB = 1000
MB = 1000 * KB
GB = 1000 * MB
TB = 1000 * GB

# ---- times ----------------------------------------------------------------
NS = 1e-9
US = 1e-6
MS = 1e-3

# ---- rates ----------------------------------------------------------------
M_IOPS = 1e6
G_IOPS = 1e9

# ---- NVIDIA H100 SXM published peaks (NVIDIA data sheet; dense, at the
# full 700 W power limit) -- the roofline bound of the port's kernels -------
H100_HBM_BW = 3.35e12           # bytes/s
H100_PEAK_FLOPS_BF16 = 989e12   # tensor cores
H100_PEAK_FLOPS_F32 = 67e12     # outside the tensor cores

SECONDS_PER_MINUTE = 60.0


def human_time(seconds: float) -> str:
    """Render a duration compactly (ns/us/ms/s/min)."""
    s = float(seconds)
    if s == float("inf"):
        return "inf"
    if s < 1e-6:
        return f"{s * 1e9:.1f}ns"
    if s < 1e-3:
        return f"{s * 1e6:.1f}us"
    if s < 1.0:
        return f"{s * 1e3:.1f}ms"
    if s < 120.0:
        return f"{s:.2f}s"
    return f"{s / 60.0:.1f}min"


def human_bytes(n: float) -> str:
    n = float(n)
    for unit, width in ((TiB, "TiB"), (GiB, "GiB"), (MiB, "MiB"), (KiB, "KiB")):
        if n >= unit:
            return f"{n / unit:.2f}{width}"
    return f"{n:.0f}B"


def human_rate(iops: float) -> str:
    iops = float(iops)
    if iops >= 1e9:
        return f"{iops / 1e9:.2f}G IOPS"
    if iops >= 1e6:
        return f"{iops / 1e6:.1f}M IOPS"
    if iops >= 1e3:
        return f"{iops / 1e3:.1f}K IOPS"
    return f"{iops:.0f} IOPS"
