"""Vectorized analytic sweeps over the first-principles model, the twin
of the reference's `ssdsim/jaxsweep.py` (`jax.vmap` there, one broadcast
here) — used by the sensitivity benchmarks to sweep large parameter
grids cheaply and by tests to cross-check the event simulator trends.

Both sweeps return float64 tensors on `resolve_device(device)`: CUDA
unless the caller names another device.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from .._device import resolve_device
from ..core.ssd_model import SsdConfig, iops_ssd_peak


def analytic_iops_grid(cfg: SsdConfig, l_blks: Sequence[int],
                       gammas: Sequence[float], phi_wa: float = 3.0,
                       device=None) -> torch.Tensor:
    """IOPS over the (block size x read:write ratio) grid.

    Returns a float64 tensor of shape (len(l_blks), len(gammas)).
    """
    dev = resolve_device(device)
    ls = torch.as_tensor(l_blks, dtype=torch.float64, device=dev)
    gs = torch.as_tensor(gammas, dtype=torch.float64, device=dev)
    return iops_ssd_peak(cfg, ls[:, None], gs[None, :], phi_wa)


def analytic_channel_bw_sweep(cfg: SsdConfig, l_blk: int,
                              bws: Sequence[float], gamma: float = 9.0,
                              phi_wa: float = 3.0,
                              device=None) -> torch.Tensor:
    """IOPS as channel bandwidth scales (paper Fig. 7c trend): a float64
    tensor of shape (len(bws),)."""
    dev = resolve_device(device)
    b_ch = torch.as_tensor(bws, dtype=torch.float64, device=dev)
    c = dataclasses.replace(cfg, b_ch=b_ch)
    l = torch.full_like(b_ch, float(l_blk))
    return iops_ssd_peak(c, l, gamma, phi_wa)
