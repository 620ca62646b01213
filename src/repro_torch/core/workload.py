"""Workload-aware thresholds (paper §V, RQ3).

A workload is a population of N_blk blocks of size l_blk with per-block mean
access intervals {tau_i}. Caching policy is threshold-T: cache exactly
S(T) = {i : tau_i <= T}. Aggregate throughputs:

  Psi_c(T) = l * sum_{i in S(T)} 1/tau_i     (served from DRAM)
  Psi_d(T) = l * sum_{i not in S(T)} 1/tau_i (served from SSD)

Zero-copy miss path: one DMA + one processor read => DRAM bandwidth demand
B_use(T) = Psi_c + 2 Psi_d = 2*Theta - Psi_c (strictly decreasing in T).

Three thresholds (all closed-form for log-normal profiles):
  T_B = min{T : B_use(T) <= B_DRAM}      (DRAM bandwidth)
  T_S = min{T : Psi_d(T) <= B_SSD}       (usable SSD bandwidth)
  T_C = max{T : |S(T)| * l <= C_DRAM}    (DRAM capacity)

Viability: max(T_B, T_S) <= T_C. Economics-optimal operation:
tau_break_even in [max(T_B,T_S), T_C].
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from .ssd_model import _f64


def ndtri(p):
    """Inverse standard-normal CDF in float64."""
    return torch.special.ndtri(_f64(p))


def _norm_cdf(x):
    """Standard-normal CDF in float64."""
    return torch.special.ndtr(_f64(x))


# ---------------------------------------------------------------------------
# Log-normal access-interval profile (closed forms)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LogNormalWorkload:
    """tau_i ~ LogNormal(mu, sigma^2); N_blk blocks of l_blk bytes."""

    mu: float
    sigma: float
    n_blk: float
    l_blk: float

    # ---- constructors ------------------------------------------------------
    @classmethod
    def from_total_throughput(cls, throughput: float, sigma: float,
                              n_blk: float, l_blk: float):
        """Pin E[aggregate throughput] = throughput (bytes/s)."""
        mu = sigma ** 2 / 2.0 + math.log(n_blk * l_blk / throughput)
        return cls(mu=mu, sigma=sigma, n_blk=n_blk, l_blk=l_blk)

    # ---- aggregates ----------------------------------------------------------
    @property
    def total_bytes(self) -> float:
        return self.n_blk * self.l_blk

    @property
    def total_throughput(self) -> float:
        """Theta = l * N * E[1/tau]."""
        return float(self.n_blk * self.l_blk
                     * math.exp(-self.mu + self.sigma ** 2 / 2.0))

    def cached_block_fraction(self, T):
        """|S(T)| / N."""
        x = (torch.log(_f64(T)) - self.mu) / self.sigma
        return _norm_cdf(x)

    def cached_bytes(self, T):
        return self.cached_block_fraction(T) * self.total_bytes

    def psi_c(self, T):
        """Cached (DRAM-served) throughput at threshold T, bytes/s."""
        x = (torch.log(_f64(T)) - self.mu
             + self.sigma ** 2) / self.sigma
        return self.total_throughput * _norm_cdf(x)

    def psi_d(self, T):
        return self.total_throughput - self.psi_c(T)

    def dram_bw_use(self, T):
        """B_use(T) = Psi_c + 2 Psi_d (zero-copy miss path, Eq. 4)."""
        return 2.0 * self.total_throughput - self.psi_c(T)

    def hit_rate_for_capacity(self, c_dram):
        """Fraction of accesses served from DRAM when the C/l hottest blocks
        are cached: Phi(Phi^{-1}(q) + sigma), q = C / (N l)."""
        q = torch.clamp(_f64(c_dram) / self.total_bytes, 0.0, 1.0)
        z = ndtri(torch.clamp(q, 1e-300, 1.0 - 1e-16))
        rate = _norm_cdf(z + self.sigma)
        return torch.where(q >= 1.0, 1.0, torch.where(q <= 0.0, 0.0, rate))

    def capacity_threshold(self, c_dram):
        """T_C: largest T whose cached set fits in c_dram bytes."""
        q = float(c_dram) / self.total_bytes
        if q >= 1.0:
            return float("inf")
        if q <= 0.0:
            return 0.0
        return float(torch.exp(self.mu + self.sigma * ndtri(q)))

    def _invert_psi_c(self, target_psi_c) -> float:
        """Smallest T with Psi_c(T) >= target (bytes/s)."""
        theta = self.total_throughput
        r = float(target_psi_c) / theta
        if r <= 0.0:
            return 0.0
        if r >= 1.0:
            return float("inf")
        z = float(ndtri(r))
        return float(math.exp(self.mu - self.sigma ** 2 + self.sigma * z))

    def bandwidth_threshold(self, b_dram) -> float:
        """T_B: existence requires B_DRAM >= Theta."""
        need = 2.0 * self.total_throughput - float(b_dram)
        return self._invert_psi_c(need)

    def ssd_threshold(self, b_ssd) -> float:
        """T_S: Psi_d(T) <= B_SSD."""
        need = self.total_throughput - float(b_ssd)
        return self._invert_psi_c(need)

    def sample_intervals(self, n: int, seed: int = 0) -> np.ndarray:
        rng = np.random.default_rng(seed)
        return np.exp(rng.normal(self.mu, self.sigma, size=n))


# ---------------------------------------------------------------------------
# Empirical profile (sorted interval array) — used for traces & property tests
# ---------------------------------------------------------------------------


class EmpiricalWorkload:
    """Same interface, computed from an explicit interval sample."""

    def __init__(self, intervals, l_blk: float, n_blk: Optional[float] = None):
        tau = np.sort(np.asarray(intervals, dtype=np.float64))
        if tau.size == 0 or np.any(tau <= 0):
            raise ValueError("intervals must be positive and non-empty")
        self.tau = tau
        self.l_blk = float(l_blk)
        # the sample may represent a larger population; scale counts/rates
        self.scale = float(n_blk) / tau.size if n_blk else 1.0
        self._rate_prefix = np.concatenate(
            [[0.0], np.cumsum(1.0 / tau)]) * self.scale

    @property
    def n_blk(self) -> float:
        return self.tau.size * self.scale

    @property
    def total_bytes(self) -> float:
        return self.n_blk * self.l_blk

    @property
    def total_throughput(self) -> float:
        return self.l_blk * self._rate_prefix[-1]

    def _k(self, T) -> int:
        return int(np.searchsorted(self.tau, T, side="right"))

    def cached_block_fraction(self, T):
        return self._k(T) / self.tau.size

    def cached_bytes(self, T):
        return self.cached_block_fraction(T) * self.total_bytes

    def psi_c(self, T):
        return self.l_blk * self._rate_prefix[self._k(T)]

    def psi_d(self, T):
        return self.total_throughput - self.psi_c(T)

    def dram_bw_use(self, T):
        return 2.0 * self.total_throughput - self.psi_c(T)

    def hit_rate_for_capacity(self, c_dram):
        k = min(int(float(c_dram) / (self.l_blk * self.scale)), self.tau.size)
        return self.l_blk * self._rate_prefix[k] / self.total_throughput

    def capacity_threshold(self, c_dram) -> float:
        k = int(float(c_dram) / (self.l_blk * self.scale))
        if k >= self.tau.size:
            return float("inf")
        if k < 1:
            return 0.0
        return float(self.tau[k - 1])

    def _invert_psi_c(self, target) -> float:
        if target <= 0:
            return 0.0
        if target > self.total_throughput:
            return float("inf")
        # smallest k with l * prefix[k] >= target
        k = int(np.searchsorted(self._rate_prefix, target / self.l_blk,
                                side="left"))
        if k < 1:
            return 0.0
        if k > self.tau.size:
            return float("inf")
        return float(self.tau[k - 1])

    def bandwidth_threshold(self, b_dram) -> float:
        return self._invert_psi_c(2.0 * self.total_throughput - float(b_dram))

    def ssd_threshold(self, b_ssd) -> float:
        return self._invert_psi_c(self.total_throughput - float(b_ssd))


# ---------------------------------------------------------------------------
# Combined threshold report
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Thresholds:
    t_b: float                 # DRAM-bandwidth threshold (s)
    t_s: float                 # SSD-bandwidth threshold (s)
    t_c: float                 # DRAM-capacity threshold (s); inf if C unset
    t_v: float                 # viability threshold max(t_b, t_s)

    @property
    def viable(self) -> bool:
        return self.t_v <= self.t_c

    def optimal(self, tau_break_even: float) -> bool:
        return self.viable and self.t_v <= tau_break_even <= self.t_c


def thresholds(workload, b_dram: float, b_ssd: float,
               c_dram: Optional[float] = None) -> Thresholds:
    t_b = float(workload.bandwidth_threshold(b_dram))
    t_s = float(workload.ssd_threshold(b_ssd))
    t_c = (float("inf") if c_dram is None
           else float(workload.capacity_threshold(c_dram)))
    return Thresholds(t_b=t_b, t_s=t_s, t_c=t_c, t_v=max(t_b, t_s))
