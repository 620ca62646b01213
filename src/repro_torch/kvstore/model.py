"""Analytical throughput model for the SSD-resident KV store (paper Fig. 8).

Combines the calibrated device model (usable IOPS under the 70% tail-
latency utilization cap), host IOPS budgets, DRAM bandwidth, the log-normal
access-interval profile (hot-pair cache hit rate as a function of DRAM
capacity), and WAL write coalescing:

  demand per op (SSD IOs)  = f_get * miss * E[reads|GET]           (1.5)
                           + f_put * (2 / c)                (RMW / coalesce)
  throughput = min( SSD_IOPS / demand, HOST_IOPS / demand_host,
                    B_DRAM / bytes_per_op )

Strong locality (sigma=1.2) raises both the cache hit rate and the WAL
coalescing factor; weak locality (sigma=0.4) keeps both near worst-case —
reproducing the paper's spread between the two regimes.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from ..core.ssd_model import (SsdConfig, gamma_from_mix, iops_ssd_peak,
                              normal_ssd, storage_next_ssd)
from ..core.workload import LogNormalWorkload


@dataclasses.dataclass(frozen=True)
class KvWorkload:
    n_items: float = 80e9
    item_bytes: float = 64.0
    get_frac: float = 0.9
    insert_frac_of_puts: float = 0.2
    sigma: float = 1.2                # locality (1.2 strong / 0.4 weak)
    wal_entries: int = 4096


@dataclasses.dataclass(frozen=True)
class KvPlatform:
    name: str
    host_iops: float                  # total budget
    b_dram: float                     # bytes/s
    n_ssd: int = 4
    ssd: SsdConfig = None
    bucket_bytes: int = 512
    util_cap: float = 0.70


def gpu_sn_platform() -> KvPlatform:
    return KvPlatform("GPU+SN", host_iops=400e6, b_dram=640e9,
                      ssd=storage_next_ssd(), bucket_bytes=512)


def cpu_sn_platform() -> KvPlatform:
    return KvPlatform("CPU+SN", host_iops=100e6, b_dram=540e9,
                      ssd=storage_next_ssd(), bucket_bytes=512)


def gpu_nr_platform() -> KvPlatform:
    return KvPlatform("GPU+NR", host_iops=400e6, b_dram=640e9,
                      ssd=normal_ssd(), bucket_bytes=4096)


def cpu_nr_platform() -> KvPlatform:
    return KvPlatform("CPU+NR", host_iops=100e6, b_dram=540e9,
                      ssd=normal_ssd(), bucket_bytes=4096)


def wal_coalescing(wl: KvWorkload) -> float:
    """Expected updates absorbed per RMW: W appends hit D(W) distinct
    buckets; c = W / D(W). Under the log-normal popularity profile hot
    keys repeat within a WAL window, so strong locality -> larger c.
    Estimated by a short deterministic simulation of the profile."""
    rng = np.random.default_rng(7)
    n_probe = 200_000
    rates = np.exp(rng.normal(0.0, wl.sigma, n_probe))
    p = rates / rates.sum()
    draws = rng.choice(n_probe, size=wl.wal_entries, p=p)
    distinct = len(np.unique(draws))
    return wl.wal_entries / max(distinct, 1)


def achievable_throughput(plat: KvPlatform, wl: KvWorkload,
                          dram_bytes: float) -> Dict[str, float]:
    """Paper Fig. 8: achievable ops/s for one platform/workload point."""
    gamma = gamma_from_mix(wl.get_frac * 100, (1 - wl.get_frac) * 100)
    peak = float(iops_ssd_peak(plat.ssd, plat.bucket_bytes, gamma, 3.0))
    ssd_iops = plat.util_cap * peak * plat.n_ssd   # device-only bound;
    # the host budget is applied as its own bound below

    # hot-pair cache: hit rate from the interval profile at this capacity
    prof = LogNormalWorkload.from_total_throughput(
        throughput=1.0, sigma=wl.sigma, n_blk=wl.n_items,
        l_blk=wl.item_bytes)
    hit = float(prof.hit_rate_for_capacity(dram_bytes))

    c = wal_coalescing(wl)
    f_put = 1.0 - wl.get_frac
    # SSD IOs per logical op
    io_get = wl.get_frac * (1.0 - hit) * 1.5
    io_put = f_put * 2.0 / c
    io_per_op = io_get + io_put
    # host issues every SSD IO (+ minor cache work, ignored)
    host_bound = plat.host_iops / max(io_per_op, 1e-12)
    ssd_bound = ssd_iops / max(io_per_op, 1e-12)
    # DRAM traffic: hits read the item; misses DMA the bucket + read
    bytes_per_op = (wl.get_frac * hit * wl.item_bytes
                    + wl.get_frac * (1 - hit) * 2.0 * plat.bucket_bytes
                    + f_put * (2.0 / c) * plat.bucket_bytes)
    dram_bound = plat.b_dram / max(bytes_per_op, 1e-12)

    tput = min(host_bound, ssd_bound, dram_bound)
    limiter = {host_bound: "host-iops", ssd_bound: "ssd",
               dram_bound: "dram-bw"}[min(host_bound, ssd_bound,
                                          dram_bound)]
    return {
        "throughput": tput, "limiter": limiter, "hit_rate": hit,
        "ssd_iops_usable": ssd_iops, "io_per_op": io_per_op,
        "coalescing": c, "peak_iops_per_ssd": peak,
    }
