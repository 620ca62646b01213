"""The port's TCO / multi-tier extension (`repro_torch.core.tco`) against
the JAX reference's `repro.core.tco`: every function at rtol 1e-12 (host
float64 on both sides, the same expressions in the same order) over both
block sizes and all four reference tiers, then the properties of
tests/test_tco.py run on the port's functions."""
import dataclasses
import itertools

import numpy as np
import pytest

from repro.core import SLC as J_SLC, storage_next_ssd as j_sn_ssd
from repro.core import tco as J
from repro_torch.core import SLC, storage_next_ssd
from repro_torch.core import tco as T
from repro_torch.core.economics import classical_break_even
from repro_torch.core.ssd_model import iops_ssd_peak

RTOL = 1e-12
L_BLKS = (512, 4096)


def _tiers(l_blk, **kw):
    return (T.reference_tiers(storage_next_ssd(SLC), l_blk=l_blk, **kw),
            J.reference_tiers(j_sn_ssd(J_SLC), l_blk=l_blk, **kw))


def test_constants_equal_the_reference():
    assert (T.KWH_JOULES, T.DEFAULT_POWER_COST, T.AMORT_SECONDS) == \
        (J.KWH_JOULES, J.DEFAULT_POWER_COST, J.AMORT_SECONDS)
    assert [f.name for f in dataclasses.fields(T.TierSpec)] == \
        [f.name for f in dataclasses.fields(J.TierSpec)]


@pytest.mark.parametrize("l_blk", L_BLKS)
@pytest.mark.parametrize("cxl_latency", [400e-9, 2e-6])
def test_reference_tiers_equal(l_blk, cxl_latency):
    port, ref = _tiers(l_blk, cxl_latency=cxl_latency)
    assert [t.name for t in port] == [t.name for t in ref] == \
        ["HBM", "DRAM", "CXL-DRAM", "FLASH-SN"]
    for p, r in zip(port, ref):
        for f in dataclasses.fields(T.TierSpec)[1:]:
            got, want = getattr(p, f.name), getattr(r, f.name)
            assert type(got) is float, (p.name, f.name, type(got))
            np.testing.assert_allclose(got, want, rtol=RTOL,
                                       err_msg=f"{p.name}.{f.name}")


@pytest.mark.parametrize("l_blk", L_BLKS)
@pytest.mark.parametrize("power_cost", [0.0, T.DEFAULT_POWER_COST, 1e-6])
def test_tco_break_even_every_pair_equal(l_blk, power_cost):
    port, ref = _tiers(l_blk)
    for i, j in itertools.permutations(range(4), 2):
        for host in (0.0, 1e-9):
            got = T.tco_break_even(l_blk, port[i], port[j], host,
                                   power_cost=power_cost)
            want = J.tco_break_even(l_blk, ref[i], ref[j], host,
                                    power_cost=power_cost)
            assert type(got) is float
            np.testing.assert_allclose(got, want, rtol=RTOL,
                                       err_msg=f"{i}->{j} host {host}")


@pytest.mark.parametrize("l_blk", L_BLKS)
@pytest.mark.parametrize("host_cost_per_io", [0.0, 2e-9])
def test_tier_ladder_and_place_equal(l_blk, host_cost_per_io):
    port, ref = _tiers(l_blk)
    got = T.tier_ladder(l_blk, port, host_cost_per_io)
    want = J.tier_ladder(l_blk, ref, host_cost_per_io)
    assert [n for n, _ in got] == [n for n, _ in want]
    np.testing.assert_allclose([t for _, t in got], [t for _, t in want],
                               rtol=RTOL)
    assert got[-1][1] == float("inf")
    taus = [0.0, 1e-6] + [t * f for _, t in want[:-1] for f in (0.5, 1.0,
                                                                 2.0)]
    for tau in taus + [3600.0, float("inf")]:
        assert T.place(tau, got) == J.place(tau, want), tau


# -- the properties of tests/test_tco.py, on the port's functions ---------

def test_zero_power_reduces_to_classical_rule():
    ssd = storage_next_ssd(SLC)
    l = 512
    iops = float(iops_ssd_peak(ssd, l, 9.0, 3.0))
    dram = T.TierSpec("DRAM", cost_per_byte=1 / 3e9, power_per_byte=0.0,
                      device_cost=1.0, device_iops=1e9, energy_per_io=0.0)
    flash = T.TierSpec("FLASH", cost_per_byte=ssd.cost /
                       ssd.total_nand_bytes, power_per_byte=0.0,
                       device_cost=ssd.cost, device_iops=iops,
                       energy_per_io=0.0)
    tau_tco = T.tco_break_even(l, dram, flash, power_cost=0.0)
    tau_classical = float(classical_break_even(l, ssd.cost, iops,
                                               dram_cost_per_byte=1 / 3e9))
    assert tau_tco == pytest.approx(tau_classical, rel=1e-9)


def test_opex_moves_the_threshold_both_ways():
    tiers = T.reference_tiers(storage_next_ssd(SLC))
    dram, flash = tiers[1], tiers[3]
    capex_only = T.tco_break_even(512, dram, flash, power_cost=0.0)
    full = T.tco_break_even(512, dram, flash)
    assert full > capex_only                      # fetch-energy dominated
    flash_noe = dataclasses.replace(flash, energy_per_io=0.0)
    rent_only = T.tco_break_even(512, dram, flash_noe)
    assert rent_only < capex_only                 # refresh power shortens


def test_ladder_is_monotone_and_places_sanely():
    ladder = T.tier_ladder(512, T.reference_tiers(storage_next_ssd(SLC)))
    assert [n for n, _ in ladder] == ["HBM", "DRAM", "CXL-DRAM", "FLASH-SN"]
    taus = [t for _, t in ladder]
    assert all(a < b for a, b in zip(taus[:-1], taus[1:])), taus
    assert T.place(1e-6, ladder) == "HBM"
    assert T.place(3600.0, ladder) == "FLASH-SN"
    assert T.place(taus[0] * 2, ladder) in ("DRAM", "CXL-DRAM")


def test_cxl_threshold_between_dram_and_flash():
    ladder = dict(T.tier_ladder(512,
                                T.reference_tiers(storage_next_ssd(SLC))))
    assert ladder["DRAM"] > ladder["HBM"]
    assert ladder["CXL-DRAM"] > ladder["DRAM"]


def test_slower_fabric_grows_cxl_tier_value():
    ssd = storage_next_ssd(SLC)
    fast = dict(T.tier_ladder(512, T.reference_tiers(ssd,
                                                     cxl_latency=200e-9)))
    slow = dict(T.tier_ladder(512, T.reference_tiers(ssd,
                                                     cxl_latency=2e-6)))
    assert slow["DRAM"] > fast["DRAM"]
