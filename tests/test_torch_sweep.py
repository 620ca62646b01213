"""The port's analytic sweeps (`repro_torch.ssdsim.sweep`, one broadcast)
against the JAX reference's `repro.ssdsim.jaxsweep` (nested `jax.vmap`):
float64 on both sides, the same expressions, rtol 1e-12, γ = inf
included."""
import math

import numpy as np
import pytest
import torch

from repro.core import ssd_model as J
from repro.ssdsim import jaxsweep
from repro_torch.core import ssd_model as P
from repro_torch.ssdsim import sweep

RTOL = 1e-12
L_BLKS = (512, 1024, 2048, 4096)
GAMMAS = (1.0, 3.0, 9.0, math.inf)
NANDS = ("SLC", "PSLC", "TLC")


def _ssds(nand, sn, **kw):
    make = "storage_next_ssd" if sn else "normal_ssd"
    return (getattr(P, make)(getattr(P, nand), **kw),
            getattr(J, make)(getattr(J, nand), **kw))


@pytest.mark.parametrize("nand", NANDS)
@pytest.mark.parametrize("sn", [True, False], ids=["sn", "normal"])
@pytest.mark.parametrize("phi_wa", [1.0, 3.0])
def test_analytic_iops_grid_equals_reference(nand, sn, phi_wa):
    port, ref = _ssds(nand, sn)
    got = sweep.analytic_iops_grid(port, L_BLKS, GAMMAS, phi_wa,
                                   device="cpu")
    want = np.asarray(jaxsweep.analytic_iops_grid(ref, L_BLKS, GAMMAS,
                                                  phi_wa))
    assert got.shape == (len(L_BLKS), len(GAMMAS)) == want.shape
    assert got.dtype == torch.float64 and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)
    # each cell is the scalar model at that point
    for i, l in enumerate(L_BLKS):
        for j, g in enumerate(GAMMAS):
            assert float(got[i, j]) == float(P.iops_ssd_peak(port, l, g,
                                                             phi_wa))


@pytest.mark.parametrize("nand", NANDS)
@pytest.mark.parametrize("l_blk", [512, 4096])
def test_channel_bw_sweep_equals_reference(nand, l_blk):
    bws = (1.2e9, 3.6e9, 4.8e9, 5.6e9, 12e9)
    port, ref = _ssds(nand, True)
    got = sweep.analytic_channel_bw_sweep(port, l_blk, bws, device="cpu")
    want = np.asarray(jaxsweep.analytic_channel_bw_sweep(ref, l_blk, bws))
    assert got.shape == (len(bws),) and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)
    # rising channel bandwidth never lowers the bound
    assert bool((got[1:] >= got[:-1]).all())


def test_grid_shape_dtype_and_empty_axes():
    ssd = P.storage_next_ssd(P.SLC)
    g = sweep.analytic_iops_grid(ssd, [512], [9.0], device="cpu")
    assert g.shape == (1, 1) and g.dtype == torch.float64
    assert float(g[0, 0]) == float(P.iops_ssd_peak(ssd, 512, 9.0, 3.0))
    assert sweep.analytic_iops_grid(ssd, [], GAMMAS,
                                    device="cpu").shape == (0, 4)


def test_exported_from_ssdsim():
    import repro_torch.ssdsim as S
    assert S.analytic_iops_grid is sweep.analytic_iops_grid
    assert "analytic_iops_grid" in S.__all__


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ssd = P.storage_next_ssd(P.SLC)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sweep.analytic_iops_grid(ssd, L_BLKS, GAMMAS)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sweep.analytic_channel_bw_sweep(ssd, 512, (3.6e9,))
