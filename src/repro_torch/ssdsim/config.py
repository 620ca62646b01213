"""Simulator configuration — reuses the analytic model's SsdConfig so the
simulator and the closed-form model are parameterized identically (Table I).
"""
from __future__ import annotations

import dataclasses

from ..core.ssd_model import SsdConfig, storage_next_ssd


@dataclasses.dataclass(frozen=True)
class SimConfig:
    ssd: SsdConfig = dataclasses.field(default_factory=storage_next_ssd)
    l_blk: int = 512
    read_frac: float = 0.9          # host read fraction (90:10 -> 0.9)
    phi_wa: float = 3.0             # intra-SSD write amplification
    # --- ECC model (paper §VI) ---
    p_bch: float = 0.0              # per-read BCH decode failure probability
    ldpc_codeword: int = 4096       # outer LDPC spans 8 x 512B sectors
    ldpc_decode_time: float = 3e-6  # iterative decode latency on escalation
    # --- run control ---
    sca_lane: bool = False          # commands on a separate CA lane
    seed: int = 0

    @property
    def blocks_per_page(self) -> int:
        return max(1, self.ssd.nand.page_bytes // self.l_blk)

    @property
    def l_eff(self) -> int:
        """Internal read size (normal SSDs round up to the ECC codeword)."""
        return max(self.l_blk, self.ssd.min_access_bytes)

    @property
    def gamma_rw(self) -> float:
        if self.read_frac >= 1.0:
            return float("inf")
        return self.read_frac / (1.0 - self.read_frac)
