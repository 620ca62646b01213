"""Analytical throughput model for two-stage SSD-resident ANN search
(paper Fig. 10): KQPS vs DRAM capacity across reduced->full geometries.

Per query:
  stage-1: V1 reduced-vector (512B) random reads, a fraction served from
           the DRAM cache of hot upper-layer HNSW nodes (layer-aware
           profile: upper layers are exponentially hotter),
  stage-2: promote_frac * V1 full-vector reads (2-8KB, bandwidth-type).

Bounds: usable SSD IOPS (tail-capped + host budget), host IOPS, DRAM
bandwidth (cache hits + DMA of both read classes).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from ..core.ssd_model import (SsdConfig, iops_ssd_peak, normal_ssd,
                              storage_next_ssd)
from ..core.workload import LogNormalWorkload


@dataclasses.dataclass(frozen=True)
class AnnWorkload:
    n_vectors: float = 8e9
    d_reduced_bytes: int = 512
    d_full_bytes: int = 4096
    beam_hops: int = 600              # HNSW traversal length (ef-style)
    degree: int = 32                  # graph degree: reads per hop
    promote_frac: float = 0.10        # fraction re-ranked on full vectors
    sigma: float = 1.6                # layer-aware skew of node popularity

    @property
    def visits_stage1(self) -> int:
        # each hop evaluates the reduced vectors of all neighbors
        return self.beam_hops * self.degree


@dataclasses.dataclass(frozen=True)
class AnnPlatform:
    name: str
    host_iops: float
    b_dram: float
    n_ssd: int = 4
    ssd: SsdConfig = None
    util_cap: float = 0.70


def gpu_sn() -> AnnPlatform:
    return AnnPlatform("GPU+SN", 400e6, 640e9, ssd=storage_next_ssd())


def cpu_sn() -> AnnPlatform:
    return AnnPlatform("CPU+SN", 100e6, 540e9, ssd=storage_next_ssd())


def gpu_nr() -> AnnPlatform:
    return AnnPlatform("GPU+NR", 400e6, 640e9, ssd=normal_ssd())


def throughput_kqps(plat: AnnPlatform, wl: AnnWorkload,
                    dram_bytes: float) -> Dict[str, float]:
    # node popularity profile (upper HNSW layers exponentially hotter)
    prof = LogNormalWorkload.from_total_throughput(
        throughput=1.0, sigma=wl.sigma, n_blk=wl.n_vectors,
        l_blk=wl.d_reduced_bytes)
    hit = float(prof.hit_rate_for_capacity(dram_bytes))

    v1_ssd = wl.visits_stage1 * (1.0 - hit)          # 512B random reads
    v2 = wl.visits_stage1 * wl.promote_frac          # full-vector reads
    # stage-2 reads issued as (d_full/512) packet-equivalents against the
    # IOPS budget? No — they are few and large: charge them against IOPS
    # once each and against bandwidth by size.
    gamma = float("inf")                             # read-only search
    peak_small = float(iops_ssd_peak(plat.ssd, wl.d_reduced_bytes, gamma,
                                     1.0))
    peak_big = float(iops_ssd_peak(plat.ssd, wl.d_full_bytes, gamma, 1.0))
    ssd_small = min(plat.util_cap * peak_small,
                    plat.host_iops / plat.n_ssd) * plat.n_ssd
    ssd_big = min(plat.util_cap * peak_big,
                  plat.host_iops / plat.n_ssd) * plat.n_ssd

    # time-shares on the device: q/s bound st v1/ssd_small + v2/ssd_big <= 1
    ssd_bound = 1.0 / max(v1_ssd / ssd_small + v2 / ssd_big, 1e-15)
    host_bound = plat.host_iops / max(v1_ssd + v2, 1e-9)
    bytes_per_q = (wl.visits_stage1 * hit * wl.d_reduced_bytes
                   + 2.0 * v1_ssd * wl.d_reduced_bytes
                   + 2.0 * v2 * wl.d_full_bytes)
    dram_bound = plat.b_dram / bytes_per_q

    qps = min(ssd_bound, host_bound, dram_bound)
    limiter = {ssd_bound: "ssd", host_bound: "host-iops",
               dram_bound: "dram-bw"}[qps]
    return {"kqps": qps / 1e3, "limiter": limiter, "hit_rate": hit,
            "ssd_iops_small": ssd_small, "ssd_iops_big": ssd_big}
