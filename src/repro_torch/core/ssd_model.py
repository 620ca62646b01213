"""First-principles SSD performance and cost model (paper §III-B, Eq. 2 family).

Peak SSD IOPS is the min of four architectural bounds:

  * the NAND-die bound        (sense/program timing x multi-plane parallelism)
  * the channel bound         (bus occupancy with SCA command timing)
  * the FTL translation bound (SSD-internal DRAM bandwidth / entry size)
  * the PCIe bound            (link bandwidth and root-complex packet rate)

scaled by the host-visible fraction (Gamma+1)/(Gamma+2*Phi_WA-1) that
accounts for garbage-collection write amplification competing with host I/O.

Everything is written on float64 tensors (`torch.float64`, set per call,
never as a global default) so configurations broadcast; plain Python
floats work too.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from .units import GB, KiB, NS, US, MS


def _f64(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float64)


# ---------------------------------------------------------------------------
# Configuration dataclasses (paper Table I / Fig. 2)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class NandConfig:
    """Per-die NAND characteristics."""

    name: str
    tau_sense: float          # array sensing latency (s)
    tau_prog: float           # page program latency (s)
    page_bytes: int           # physical page size l_PG
    n_plane: int              # independently readable planes per die
    die_bytes: float          # capacity per die C_NAND
    cost: float = 1.0         # normalized die cost (NAND die == 1.0)


# Table I rows.
SLC = NandConfig("SLC", tau_sense=5 * US, tau_prog=50 * US,
                 page_bytes=4 * KiB, n_plane=6, die_bytes=32 * GB)
PSLC = NandConfig("pSLC", tau_sense=20 * US, tau_prog=150 * US,
                  page_bytes=16 * KiB, n_plane=4, die_bytes=42 * GB)
TLC = NandConfig("TLC", tau_sense=40 * US, tau_prog=1 * MS,
                 page_bytes=16 * KiB, n_plane=4, die_bytes=128 * GB)

NAND_TYPES = {"slc": SLC, "pslc": PSLC, "tlc": TLC}


@dataclasses.dataclass(frozen=True)
class SsdConfig:
    """Whole-device architecture (paper Fig. 2 + Table I bottom row)."""

    nand: NandConfig
    n_ch: int = 20                   # channels
    n_nand: int = 4                  # dies per channel
    b_ch: float = 3.6e9              # channel bandwidth (B/s)
    tau_cmd: float = 150 * NS        # per-command bus occupancy (SCA)
    # FTL / controller
    ftl_entry_bytes: float = 8.0
    b_ssd_dram: float = 40e9         # SSD-internal DRAM bandwidth
    s_dram_die_bytes: float = 3 * GB # capacity per internal DRAM die
    # PCIe
    b_pcie: float = 64e9             # effective link bandwidth (Gen7 x4)
    pps_host: float = 200e6          # root-complex packet rate
    pkts_per_io: int = 2             # transactions per request (cmd + data)
    # normalized component costs (Table III)
    alpha_ctrl: float = 15.0
    alpha_s_dram: float = 1.0
    # "Normal" SSDs have 4KB-oriented ECC/controller: sub-4KB requests are
    # served as 4KB reads internally, flattening small-block IOPS.
    min_access_bytes: int = 512

    # ---- derived ----------------------------------------------------------
    @property
    def total_nand_bytes(self) -> float:
        return self.n_ch * self.n_nand * self.nand.die_bytes

    @property
    def ftl_bytes(self) -> float:
        # one entry per 512B of media (finest mapping granularity)
        return self.total_nand_bytes / 512.0 * self.ftl_entry_bytes

    @property
    def n_s_dram(self) -> int:
        return int(math.ceil(self.ftl_bytes / self.s_dram_die_bytes))

    @property
    def cost(self) -> float:
        """Normalized capital cost (NAND die == 1)."""
        return (self.alpha_ctrl
                + self.n_ch * self.n_nand * self.nand.cost
                + self.n_s_dram * self.alpha_s_dram)


def storage_next_ssd(nand: NandConfig = SLC, **kw) -> SsdConfig:
    """Storage-Next SSD: fine-grained (512B) ECC, SCA command timing."""
    return SsdConfig(nand=nand, min_access_bytes=512, **kw)


def normal_ssd(nand: NandConfig = SLC, **kw) -> SsdConfig:
    """Conventional SSD: 4KB ECC codewords -> sub-4KB reads cost a full 4KB."""
    kw.setdefault("tau_cmd", 1.2 * US)   # conventional 8-bit CMD/ADDR bus
    return SsdConfig(nand=nand, min_access_bytes=4 * KiB, **kw)


# ---------------------------------------------------------------------------
# Workload mix helpers
# ---------------------------------------------------------------------------


def rw_fractions(gamma_rw, phi_wa):
    """Internal read/write operation fractions (paper §III-B).

    gamma_rw: host read:write ratio (reads per write). May be inf for
      read-only workloads.
    phi_wa:  intra-SSD write amplification (>= 1).
    Returns (R_r, R_w, host_fraction) where host_fraction =
      (gamma+1)/(gamma+2*phi-1) converts internal op rate to host-visible
      IOPS.
    """
    gamma_rw = _f64(gamma_rw)
    phi_wa = _f64(phi_wa)
    inf = torch.isinf(gamma_rw)
    g = torch.where(inf, 1.0, gamma_rw)  # placeholder to avoid inf arithmetic
    denom = g + 2.0 * phi_wa - 1.0
    r_r = torch.where(inf, 1.0, (g + phi_wa - 1.0) / denom)
    r_w = torch.where(inf, 0.0, phi_wa / denom)
    host_frac = torch.where(inf, 1.0, (g + 1.0) / denom)
    return r_r, r_w, host_frac


def gamma_from_mix(read_pct: float, write_pct: float) -> float:
    """90:10 -> 9.0; 100:0 -> inf."""
    if write_pct == 0:
        return float("inf")
    return read_pct / write_pct


# ---------------------------------------------------------------------------
# Per-component IOPS bounds (paper §III-B)
# ---------------------------------------------------------------------------


def effective_block(cfg: SsdConfig, l_blk):
    """Internal access size: normal SSDs round sub-4KB up to the codeword."""
    return torch.clamp(_f64(l_blk), min=float(cfg.min_access_bytes))


def iops_nand_peak(cfg: SsdConfig, l_blk, r_r, r_w):
    """Per-die IOPS bound from sense/program timing and plane parallelism."""
    nand = cfg.nand
    l_eff = effective_block(cfg, l_blk)
    reads = nand.n_plane / nand.tau_sense
    writes = nand.n_plane * nand.page_bytes / (nand.tau_prog * l_eff)
    return r_r * reads + r_w * writes


def iops_ch_peak(cfg: SsdConfig, l_blk, r_r, r_w):
    """Per-channel IOPS bound from bus occupancy (SCA command + transfer)."""
    nand = cfg.nand
    l_eff = effective_block(cfg, l_blk)
    tau_r = cfg.tau_cmd + l_eff / cfg.b_ch
    # a program moves a full page but commits page/l_blk host blocks
    tau_w_per_blk = (l_eff / nand.page_bytes) * cfg.tau_cmd + l_eff / cfg.b_ch
    return r_r / tau_r + r_w / tau_w_per_blk


def iops_xlat_peak(cfg: SsdConfig):
    """FTL translation bound: internal-DRAM bandwidth / entry size."""
    return _f64(cfg.b_ssd_dram / cfg.ftl_entry_bytes)


def iops_pcie_peak(cfg: SsdConfig, l_blk):
    """Interconnect bound: link bandwidth and packet-processing rate (Eq. 3)."""
    l_blk = _f64(l_blk)
    return torch.minimum(cfg.b_pcie / l_blk,
                         _f64(cfg.pps_host / cfg.pkts_per_io))


def iops_dev_peak(cfg: SsdConfig, l_blk, gamma_rw, phi_wa):
    """Memory-device-limited IOPS (die/channel mins, host-visible)."""
    r_r, r_w, host_frac = rw_fractions(gamma_rw, phi_wa)
    per_die = iops_nand_peak(cfg, l_blk, r_r, r_w)
    per_ch = iops_ch_peak(cfg, l_blk, r_r, r_w)
    internal = cfg.n_ch * torch.minimum(cfg.n_nand * per_die, per_ch)
    return host_frac * internal


def iops_ssd_peak(cfg: SsdConfig, l_blk, gamma_rw=9.0, phi_wa=3.0):
    """Overall peak SSD IOPS (paper Eq. 2)."""
    dev = iops_dev_peak(cfg, l_blk, gamma_rw, phi_wa)
    return torch.minimum(torch.minimum(dev, iops_xlat_peak(cfg)),
                         iops_pcie_peak(cfg, l_blk))


def bottleneck(cfg: SsdConfig, l_blk, gamma_rw=9.0, phi_wa=3.0) -> str:
    """Which architectural bound limits the device at this operating point."""
    r_r, r_w, _ = rw_fractions(gamma_rw, phi_wa)
    terms = {
        "nand_die": float(cfg.n_ch * cfg.n_nand
                          * iops_nand_peak(cfg, l_blk, r_r, r_w)),
        "channel": float(cfg.n_ch * iops_ch_peak(cfg, l_blk, r_r, r_w)),
        "ftl_xlat": float(iops_xlat_peak(cfg)),
        "pcie": float(iops_pcie_peak(cfg, l_blk)),
    }
    return min(terms, key=terms.get)


# ---------------------------------------------------------------------------
# Convenience: classical datasheet-style summary
# ---------------------------------------------------------------------------


def describe(cfg: SsdConfig, l_blks=(512, 1024, 2048, 4096),
             gamma_rw=9.0, phi_wa=3.0) -> dict:
    out = {
        "name": f"{cfg.nand.name} x {cfg.n_ch}ch x {cfg.n_nand}die",
        "capacity_bytes": cfg.total_nand_bytes,
        "cost": cfg.cost,
        "n_s_dram": cfg.n_s_dram,
    }
    for l in l_blks:
        out[f"iops@{l}"] = float(iops_ssd_peak(cfg, l, gamma_rw, phi_wa))
        out[f"bound@{l}"] = bottleneck(cfg, l, gamma_rw, phi_wa)
    return out
