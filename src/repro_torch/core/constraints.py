"""Constraint-aware usable IOPS (paper §IV, RQ2).

Each NAND channel is modeled as an M/D/1 queue: Poisson arrivals,
deterministic service, one request in service per channel. With per-channel
service time S = N_CH / IOPS_peak and utilization rho:

  mean read latency:  tau_mean(rho) = S * rho / (2 (1 - rho)) + tau_sense
  p-tail latency:     tau_p(rho)    = S * rho / (2 (1 - rho)) * ln(1/(1-p))
                                      + tau_sense        (Kingman exponential)

Both are monotone in rho, so the largest admissible utilization has the
closed form rho = 2c / (1 + 2c) with c = (tau_hat - tau_sense) / (S * k),
k = ln(1/(1-p)) for the tail constraint and k = 1 for the mean constraint.

Usable SSD IOPS then also respects the host budget:
  IOPS_ssd = min(rho_max * IOPS_peak, IOPS_proc / N_ssd).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import math

import torch

from .ssd_model import _f64


@dataclasses.dataclass(frozen=True)
class LatencyTargets:
    """Application-level read-latency constraints (None = unconstrained)."""

    mean: Optional[float] = None       # seconds
    tail: Optional[float] = None       # seconds
    tail_percentile: float = 0.99


def _queue_time(rho, n_ch, iops_peak):
    service = n_ch / _f64(iops_peak)
    rho = _f64(rho)
    return service * rho / (2.0 * (1.0 - rho))


def mean_read_latency(rho, n_ch, iops_peak, tau_sense):
    return _queue_time(rho, n_ch, iops_peak) + tau_sense


def tail_read_latency(rho, n_ch, iops_peak, tau_sense, p=0.99):
    k = math.log(1.0 / (1.0 - p))
    return _queue_time(rho, n_ch, iops_peak) * k + tau_sense


def _rho_closed_form(tau_hat, tau_sense, service, k):
    """Largest rho with S * rho/(2(1-rho)) * k <= tau_hat - tau_sense."""
    headroom = _f64(tau_hat) - tau_sense
    c = headroom / (service * k)
    rho = 2.0 * c / (1.0 + 2.0 * c)
    # no headroom -> cannot admit load at all
    return torch.clamp(torch.where(headroom <= 0.0, 0.0, rho), 0.0, 1.0)


def rho_max_for_targets(targets: LatencyTargets, n_ch, iops_peak, tau_sense):
    """Largest channel utilization meeting both latency targets."""
    service = n_ch / _f64(iops_peak)
    rho = _f64(1.0)
    if targets.mean is not None:
        rho = torch.minimum(rho, _rho_closed_form(
            targets.mean, tau_sense, service, 1.0))
    if targets.tail is not None:
        k = math.log(1.0 / (1.0 - targets.tail_percentile))
        rho = torch.minimum(rho, _rho_closed_form(
            targets.tail, tau_sense, service, k))
    return rho


def usable_iops(iops_peak, rho_max, iops_proc, n_ssd=1):
    """Feasibility-capped SSD IOPS (paper §IV final expression)."""
    return torch.minimum(_f64(rho_max) * iops_peak,
                         _f64(iops_proc) / n_ssd)
