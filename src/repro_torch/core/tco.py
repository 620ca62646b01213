"""Beyond-paper extension (paper §VIII "Device and cost modeling" and
"System integration and topology"): a total-cost-of-ownership break-even
that adds OpEx to Gray's CapEx-only rent, and the pairwise multi-tier
analysis the paper sketches for CXL-attached memory.

Units (everything amortized to rates):
  rent_rate [$/s]  = l_blk * (cost_per_byte / amort_s
                              + power_per_byte * $_per_joule)
  io_cost   [$]    = device_cost / (device_IOPS * amort_s)   (CapEx share)
                   + energy_per_io * $_per_joule             (OpEx share)
  tau_be    [s]    = io_cost / rent_rate

With power terms zeroed this reduces exactly to the paper's Eq. 1 SSD
term (the amortization cancels), so the CapEx-only results in
`economics.py` are the special case — validated in tests.

Pairwise ladder: apply the same break-even between each adjacent pair of
an ordered hierarchy (HBM, DRAM, CXL-DRAM, Storage-Next flash); fabric
tiers enter through their effective IOPS = 1/(latency + l/bw). The result
is a reuse-interval ladder generalizing `TieringPolicy` to N tiers.

Host float64 analytics: every result is a Python float (the flash
tier's IOPS comes through `iops_ssd_peak` as a float64 tensor and is
converted where it enters a `TierSpec`).
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

from .ssd_model import SsdConfig, iops_ssd_peak

KWH_JOULES = 3.6e6
DEFAULT_POWER_COST = 0.10 / KWH_JOULES      # $ per joule ($0.10/kWh)
AMORT_SECONDS = 5 * 365 * 86400             # 5-year depreciation


@dataclasses.dataclass(frozen=True)
class TierSpec:
    """One memory/storage tier for the pairwise ladder. Costs are in the
    paper's normalized NAND-die units."""

    name: str
    cost_per_byte: float          # capital, per resident byte
    power_per_byte: float         # W per resident byte (refresh etc.)
    device_cost: float            # capital cost of the serving device
    device_iops: float            # attainable IOPS at l_blk
    energy_per_io: float          # J per access (dynamic)


def tco_break_even(l_blk: float, upper: TierSpec, lower: TierSpec,
                   host_cost_per_io: float = 0.0,
                   power_cost: float = DEFAULT_POWER_COST,
                   amort_s: float = AMORT_SECONDS) -> float:
    """Break-even reuse interval between an adjacent tier pair, with OpEx.

    `host_cost_per_io` carries the paper's host term ($ per IO, already
    amortized the same way) when the lower tier sits behind the I/O stack.
    """
    rent_rate = l_blk * (upper.cost_per_byte / amort_s
                         + upper.power_per_byte * power_cost)
    io_cost = (lower.device_cost / (lower.device_iops * amort_s)
               + host_cost_per_io
               + lower.energy_per_io * power_cost)
    return float(io_cost / rent_rate)


def tier_ladder(l_blk: float, tiers: Sequence[TierSpec],
                host_cost_per_io: float = 0.0,
                power_cost: float = DEFAULT_POWER_COST
                ) -> List[Tuple[str, float]]:
    """[(tier name, max reuse interval to stay in it)] for the hierarchy:
    an object with reuse interval tau lives in the first tier whose
    threshold exceeds tau."""
    out = []
    for hi, lo in zip(tiers[:-1], tiers[1:]):
        host = host_cost_per_io if lo.name.startswith("FLASH") else 0.0
        out.append((hi.name,
                    tco_break_even(l_blk, hi, lo, host,
                                   power_cost=power_cost)))
    out.append((tiers[-1].name, float("inf")))
    return out


def place(tau: float, ladder: List[Tuple[str, float]]) -> str:
    for name, thresh in ladder:
        if tau <= thresh:
            return name
    return ladder[-1][0]


# ---------------------------------------------------------------------------
# Reference 2025 hierarchy (normalized NAND-die units, Table III anchors)
# ---------------------------------------------------------------------------

def reference_tiers(ssd: SsdConfig, l_blk: int = 512,
                    cxl_latency: float = 400e-9,
                    cxl_bw: float = 64e9) -> List[TierSpec]:
    """HBM / DRAM / CXL-DRAM / Storage-Next-flash ladder.

    DRAM die: 1 unit per 3GB, ~1e9 IOPS at 512B (Table III);
    HBM: ~4x DRAM $/byte, higher bandwidth/lower energy per bit moved;
    CXL-DRAM: DRAM silicon + fabric premium, IOPS set by link physics;
    flash: the first-principles device model."""
    ssd_iops = float(iops_ssd_peak(ssd, l_blk, 9.0, 3.0))
    dram_cpb = 1.0 / 3e9
    cxl_iops = 1.0 / (cxl_latency + l_blk / cxl_bw)
    return [
        TierSpec("HBM", cost_per_byte=4 * dram_cpb, power_per_byte=1.2e-10,
                 device_cost=4.0, device_iops=5e9,
                 energy_per_io=l_blk * 3.5e-12),
        TierSpec("DRAM", cost_per_byte=dram_cpb, power_per_byte=1.0e-10,
                 device_cost=1.0, device_iops=1e9,
                 energy_per_io=l_blk * 8e-12),
        TierSpec("CXL-DRAM", cost_per_byte=1.3 * dram_cpb,
                 power_per_byte=1.0e-10, device_cost=1.3,
                 device_iops=cxl_iops, energy_per_io=l_blk * 15e-12),
        TierSpec("FLASH-SN", cost_per_byte=ssd.cost / ssd.total_nand_bytes,
                 power_per_byte=5e-12, device_cost=ssd.cost,
                 device_iops=ssd_iops, energy_per_io=8e-6),
    ]
