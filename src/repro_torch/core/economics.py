"""Calibrated economic break-even model (paper §III-A, Eq. 1) plus the
classical Gray/Putzolu form it reduces to.

Costs are normalized to the NAND-die cost (Table III). Host DRAM cost and
bandwidth/capacity are per-die figures; the break-even interval only depends
on the per-die ratios, so totals are not needed here (they enter the
feasibility analysis in platform.py instead).
"""
from __future__ import annotations

import dataclasses

from .ssd_model import SsdConfig, _f64, iops_ssd_peak


@dataclasses.dataclass(frozen=True)
class HostConfig:
    """Host-side cost/performance parameters (paper Table III row)."""

    name: str
    alpha_h_dram: float       # normalized cost per host-DRAM die
    b_h_dram_die: float       # bandwidth per DRAM die (B/s)
    c_h_dram_die: float       # capacity per DRAM die (bytes)
    alpha_core: float         # normalized cost per core / SM
    iops_core: float          # sustainable IOPS per core / SM


CPU_DDR = HostConfig("CPU+DDR", alpha_h_dram=1.0, b_h_dram_die=3e9,
                     c_h_dram_die=3e9, alpha_core=4.0, iops_core=1e6)
GPU_GDDR = HostConfig("GPU+GDDR", alpha_h_dram=2.0, b_h_dram_die=80e9,
                      c_h_dram_die=2e9, alpha_core=3.0, iops_core=4e6)


def break_even_components(host: HostConfig, l_blk, ssd_cost, iops_ssd):
    """Per-term contributions to the break-even interval, in seconds.

    Returns dict with 'host', 'dram_bw', 'ssd' components; their sum is the
    calibrated break-even interval (Eq. 1).
    """
    l_blk = _f64(l_blk)
    # $ per I/O for each resource
    c_host_io = host.alpha_core / host.iops_core
    c_dram_io = l_blk * host.alpha_h_dram / host.b_h_dram_die
    c_ssd_io = _f64(ssd_cost) / _f64(iops_ssd)
    # DRAM rent rate: $ per second to hold the block resident
    rent_rate = l_blk * host.alpha_h_dram / host.c_h_dram_die
    return {
        "host": c_host_io / rent_rate,
        "dram_bw": c_dram_io / rent_rate,
        "ssd": c_ssd_io / rent_rate,
    }


def break_even(host: HostConfig, l_blk, ssd_cost, iops_ssd):
    """Calibrated break-even interval tau_be (seconds), Eq. 1."""
    c = break_even_components(host, l_blk, ssd_cost, iops_ssd)
    return c["host"] + c["dram_bw"] + c["ssd"]


def break_even_components_gpu_direct(host: HostConfig, l_blk, ssd_cost,
                                     iops_ssd, *, alpha_submit: float = 0.5,
                                     iops_submit: float = 2e7):
    """Eq. 1 column for the BaM-style GPU-direct flash *path*.

    Same NAND as the host-flash column, different path: the accelerator
    submits IOs straight to the device queue, so the host-CPU term
    (`alpha_core/iops_core`) and the host-DRAM wire term both vanish.
    What replaces them is a (much cheaper) accelerator submission-engine
    term — a few SMs drive millions of IOPS, so
    `alpha_submit/iops_submit` is orders of magnitude below the host
    per-IO cost. The denominator is unchanged (the question is still
    "is DRAM residency worth the rent"), so tau_be drops structurally:
    the DRAM-vs-storage threshold tightens when the storage path stops
    paying host rent.

    Returns {'submit', 'ssd'} components; their sum is tau_be for the
    gpu_flash column.
    """
    l_blk = _f64(l_blk)
    c_submit = alpha_submit / iops_submit
    c_ssd_io = _f64(ssd_cost) / _f64(iops_ssd)
    rent_rate = l_blk * host.alpha_h_dram / host.c_h_dram_die
    return {
        "submit": c_submit / rent_rate,
        "ssd": c_ssd_io / rent_rate,
    }


def break_even_gpu_direct(host: HostConfig, l_blk, ssd_cost, iops_ssd,
                          **kw):
    """tau_be for the GPU-direct flash column (seconds)."""
    c = break_even_components_gpu_direct(host, l_blk, ssd_cost, iops_ssd,
                                         **kw)
    return c["submit"] + c["ssd"]


def break_even_components_pool(host: HostConfig, l_blk, *,
                               pool_bw: float = 12.5e9,
                               pool_rtt: float = 25e-6,
                               rent_factor: float = 0.5,
                               alpha_net: float = 2.0):
    """Eq. 1 column for the fleet-shared far-memory pool.

    The pool is DRAM-medium, so moving a block out of local DRAM does
    not stop the rent — it *discounts* it: pooled capacity is rented at
    `rent_factor` of the local rate because uncorrelated per-host peaks
    statistically multiplex onto one shared provision. The break-even
    interval therefore divides the fetch cost by the rent
    *differential* `rent_dram * (1 - rent_factor)`, not the full rent:

        tau_be_pool = c_pool_io / (rent_dram * (1 - rent_factor))

    c_pool_io has a fabric wire term (`l_blk * alpha_net / pool_bw`)
    and an RTT term (`alpha_net * pool_rtt` — the lane is held for one
    round trip per IO, priced at the port's capital-as-rent rate).

    Returns {'pool_wire', 'pool_rtt'} components; their sum is tau_be
    for the pool column.
    """
    if not 0.0 <= rent_factor < 1.0:
        raise ValueError(
            f"rent_factor must be in [0, 1) (got {rent_factor}): at 1.0 "
            "the pool rents at the local-DRAM rate and can never win")
    l_blk = _f64(l_blk)
    rent_dram = l_blk * host.alpha_h_dram / host.c_h_dram_die
    rent_saved = rent_dram * (1.0 - rent_factor)
    c_wire = l_blk * alpha_net / pool_bw
    c_rtt = alpha_net * pool_rtt
    return {
        "pool_wire": c_wire / rent_saved,
        "pool_rtt": c_rtt / rent_saved,
    }


def break_even_pool(host: HostConfig, l_blk, **kw):
    """tau_be for the pool column (seconds)."""
    c = break_even_components_pool(host, l_blk, **kw)
    return c["pool_wire"] + c["pool_rtt"]


def pool_flash_crossover(host: HostConfig, l_blk, tau_be, *,
                         pool_bw: float = 12.5e9,
                         pool_rtt: float = 25e-6,
                         rent_factor: float = 0.5,
                         alpha_net: float = 2.0):
    """Upper edge of the pool band: the reuse interval beyond which a
    flash re-read underprices pooled residency.

    `break_even_pool` is the pool-vs-local-DRAM edge (where the
    discounted rent starts beating full rent). This is the other side
    of the band: pooled bytes still pay `rent_factor` of the DRAM rate
    per byte-second plus `c_pool_io` per access, while a flash-resident
    byte pays only the flash column's IO cost (`tau_be * rent_dram` per
    access, by Eq. 1's own definition). Pool wins iff

        c_pool_io + rent_factor * rent_dram * tau  <  tau_be * rent_dram

    i.e. tau < (tau_be - c_pool_io / rent_dram) / rent_factor. A result
    at or below tau_be means the band is empty — the pool's own access
    cost exceeds a flash IO and no interval prefers it.
    """
    if not 0.0 < rent_factor < 1.0:
        raise ValueError(
            f"rent_factor must be in (0, 1) (got {rent_factor})")
    l_blk = _f64(l_blk)
    rent_dram = l_blk * host.alpha_h_dram / host.c_h_dram_die
    c_pool_io = l_blk * alpha_net / pool_bw + alpha_net * pool_rtt
    return (_f64(tau_be)
            - c_pool_io / rent_dram) / rent_factor


def break_even_for_ssd(host: HostConfig, ssd: SsdConfig, l_blk,
                       gamma_rw=9.0, phi_wa=3.0, iops_ssd=None):
    """Break-even using the first-principles device model for the SSD term.

    iops_ssd overrides the peak (e.g. a feasibility-capped usable IOPS from
    constraints.py).
    """
    if iops_ssd is None:
        iops_ssd = iops_ssd_peak(ssd, l_blk, gamma_rw, phi_wa)
    return break_even(host, l_blk, ssd.cost, iops_ssd)


def classical_break_even(l_blk, ssd_cost, iops_ssd, dram_cost_per_byte):
    """Gray's economics-only rule: T = C_ssd_io / C_dram_page.

    With host terms dropped and peak IOPS assumed, Eq. 1 reduces to this.
    dram_cost_per_byte is in the same normalized units as ssd_cost.
    """
    c_ssd_io = _f64(ssd_cost) / _f64(iops_ssd)
    c_dram_page = _f64(l_blk) * dram_cost_per_byte
    return c_ssd_io / c_dram_page
