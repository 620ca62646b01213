"""Core analytics, ssdsim calibration and the single-host tiering runtime
of the PyTorch port against the JAX reference package.

Analytics compare at rtol 1e-12: both sides compute the same float64
expressions, so only the last bits of a transcendental may differ. The
DES calibration and the virtual-clock runtime are numpy/Python on both
sides and must agree exactly."""
import dataclasses

import numpy as np
import pytest

import repro.core as J
import repro_torch.core as T
from repro.runtime.service import SsdQueueModel as JQ
from repro.runtime.tiers import TieredStore as JStore, TierSpec as JSpec
from repro.runtime.clock import VirtualClock as JClock
from repro.ssdsim.config import SimConfig as JSim
from repro_torch.runtime.clock import VirtualClock as TClock
from repro_torch.runtime.service import SsdQueueModel as TQ
from repro_torch.runtime.tiers import TieredStore as TStore, \
    TierSpec as TSpec
from repro_torch.ssdsim.config import SimConfig as TSim

RTOL = 1e-12


def _close(a, b):
    np.testing.assert_allclose(float(a), float(b), rtol=RTOL, atol=0.0)


SSDS = [("storage_next", "slc"), ("storage_next", "tlc"),
        ("normal", "pslc")]


def _ssd(pkg, kind, nand):
    return getattr(pkg, f"{kind}_ssd" if kind == "normal"
                   else "storage_next_ssd")(pkg.NAND_TYPES[nand])


@pytest.mark.parametrize("kind,nand", SSDS)
@pytest.mark.parametrize("l_blk", [512, 4096])
@pytest.mark.parametrize("gamma", [9.0, float("inf")])
def test_iops_and_break_even_match(kind, nand, l_blk, gamma):
    js, ts = _ssd(J, kind, nand), _ssd(T, kind, nand)
    _close(T.iops_ssd_peak(ts, l_blk, gamma, 3.0),
           J.iops_ssd_peak(js, l_blk, gamma, 3.0))
    assert T.bottleneck(ts, l_blk, gamma) == J.bottleneck(js, l_blk, gamma)
    for jh, th in ((J.CPU_DDR, T.CPU_DDR), (J.GPU_GDDR, T.GPU_GDDR)):
        iops = J.iops_ssd_peak(js, l_blk, gamma, 3.0)
        _close(T.break_even(th, l_blk, ts.cost, float(iops)),
               J.break_even(jh, l_blk, js.cost, iops))
        jc = J.break_even_components(jh, l_blk, js.cost, iops)
        tc = T.break_even_components(th, l_blk, ts.cost, float(iops))
        assert set(jc) == set(tc)
        for k in jc:
            _close(tc[k], jc[k])
        from repro.core.economics import break_even_for_ssd as jbe
        from repro_torch.core.economics import break_even_for_ssd as tbe
        _close(tbe(th, ts, l_blk, gamma), jbe(jh, js, l_blk, gamma))
    _close(T.classical_break_even(l_blk, ts.cost, 1e6, 2e-10),
           J.classical_break_even(l_blk, js.cost, 1e6, 2e-10))


@pytest.mark.parametrize("wl", ["lognormal", "empirical"])
@pytest.mark.parametrize("c_dram", [None, 64e9])
def test_thresholds_and_platform_match(wl, c_dram):
    if wl == "lognormal":
        jw = J.LogNormalWorkload.from_total_throughput(100e9, 1.5, 1e9, 512)
        tw = T.LogNormalWorkload.from_total_throughput(100e9, 1.5, 1e9, 512)
    else:
        iv = np.random.default_rng(3).lognormal(0.0, 2.0, 5000)
        jw = J.EmpiricalWorkload(iv, 512, n_blk=1e8)
        tw = T.EmpiricalWorkload(iv, 512, n_blk=1e8)
    jt = J.thresholds(jw, 540e9, 20e9, c_dram)
    tt = T.thresholds(tw, 540e9, 20e9, c_dram)
    for f in ("t_b", "t_s", "t_c", "t_v"):
        a, b = getattr(tt, f), getattr(jt, f)
        assert a == b or np.isclose(a, b, rtol=RTOL, atol=0.0), (f, a, b)
    _close(tw.hit_rate_for_capacity(32e9), jw.hit_rate_for_capacity(32e9))
    _close(tw.cached_bytes(2.0), jw.cached_bytes(2.0))
    for jp, tp in ((J.CPU_PLATFORM, T.CPU_PLATFORM),
                   (J.GPU_PLATFORM, T.GPU_PLATFORM)):
        targets = dict(tail=200e-6)
        jr = J.analyze_platform(dataclasses.replace(jp, c_dram_total=c_dram),
                                jw, 512, J.LatencyTargets(**targets))
        tr = T.analyze_platform(dataclasses.replace(tp, c_dram_total=c_dram),
                                tw, 512, T.LatencyTargets(**targets))
        assert (tr.verdict, tr.recommendation, tr.host_limited) == \
            (jr.verdict, jr.recommendation, jr.host_limited)
        for f in ("iops_ssd_peak", "rho_max", "iops_ssd_usable",
                  "tau_break_even", "c_dram_viable", "c_dram_optimal",
                  "dram_bw_use_viable", "dram_bw_use_optimal"):
            _close(getattr(tr, f), getattr(jr, f))


@pytest.mark.parametrize("l_blk", [512, 4096, 1 << 20])
@pytest.mark.parametrize("hbm", [False, True])
def test_policy_from_platform_matches(l_blk, hbm):
    kw = dict(hbm=J.GPU_GDDR) if hbm else {}
    jp = J.TieringPolicy.from_platform(J.CPU_PLATFORM, l_blk, **kw)
    kw = dict(hbm=T.GPU_GDDR) if hbm else {}
    tp = T.TieringPolicy.from_platform(T.CPU_PLATFORM, l_blk, **kw)
    _close(tp.tau_be, jp.tau_be)
    _close(tp.tau_hot, jp.tau_hot)
    iv = np.array([1e-4, 0.01, 1.0, 30.0, 1e4])
    want = np.asarray(jp.tiers_for_intervals(iv))
    got = tp.tiers_for_intervals(iv)
    assert str(got.dtype) == "torch.int8"
    np.testing.assert_array_equal(got.numpy(), want)


def test_ssd_queue_model_calibration_is_bit_identical():
    jm = JQ(JSim(l_blk=4096, read_frac=0.9), n_ops=600)
    tm = TQ(TSim(l_blk=4096, read_frac=0.9), n_ops=600)
    assert jm.calibration() == tm.calibration()
    for d in (1, 3, 17, 200):
        assert dataclasses.astuple(jm.service(1 << 20, d)) == \
            dataclasses.astuple(tm.service(1 << 20, d))
        assert jm.p99(d) == tm.p99(d)


def test_calibration_cache_files_are_namespaced(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_SSDSIM_CACHE", str(tmp_path))
    jm = JQ(JSim(l_blk=4096, read_frac=0.9), n_ops=300)
    tm = TQ(TSim(l_blk=4096, read_frac=0.9), n_ops=300)
    jp, tp = jm._cache_path(), tm._cache_path()
    assert jp.parent == tp.parent == tmp_path
    assert jp.name != tp.name
    assert tp.name.startswith("ssdcal-torch-")
    tm.calibration()
    assert tp.is_file() and not jp.exists()
    # a fresh port model reads its own file back, the reference does not
    assert TQ(TSim(l_blk=4096, read_frac=0.9), n_ops=300)._load_cached()
    assert not JQ(JSim(l_blk=4096, read_frac=0.9), n_ops=300)._load_cached()


def _drive(pkg_store, pkg_spec, pkg_clock, policy_cls, tier_cls, seed):
    """A seeded mix of put / get / get_async+wait / delete / clock
    advances under capacity pressure; returns everything observable."""
    rng = np.random.default_rng(seed)
    clock = pkg_clock()
    specs = {tier_cls.HBM: pkg_spec(40_000, 819e9, 1e-7),
             tier_cls.DRAM: pkg_spec(120_000, 45e9, 5e-7),
             tier_cls.FLASH: pkg_spec(4e12, 7e9, 2e-5)}
    store = pkg_store(policy_cls(tau_hot=0.01, tau_be=0.5),
                      specs=specs, clock=clock,
                      write_shield_depth=2 if seed % 2 else None)
    keys = [f"k{i}" for i in range(12)]
    pending, trace = [], []
    for _ in range(300):
        op = rng.integers(0, 6)
        key = keys[rng.integers(0, len(keys))]
        present = store.tier_of(key) is not None
        if op == 0 or not present:
            n = int(rng.integers(1, 8)) * 4096
            store.put(key, np.full(n // 4, rng.random(), np.float32))
        elif op == 1:
            trace.append(float(store.get(key)[0]))
        elif op == 2:
            pending.append(store.get_async(key))
        elif op == 3 and pending:
            trace.append(float(pending.pop(0).wait()[0]))
        elif op == 4:
            store.delete(key)
        clock.advance(float(rng.exponential(0.05)))
        trace.append((clock.now(), None if store.tier_of(key) is None
                      else int(store.tier_of(key))))
    trace.append((store.report(), store.runtime.report(),
                  store.runtime.drain(), store.snapshot_stats()))
    stats = {t.name: dataclasses.asdict(s) for t, s in store.stats.items()}
    qstats = {t.name: dataclasses.asdict(s)
              for t, s in store.runtime.qstats.items()}
    return trace, stats, qstats, store.ledger.as_dict(), clock.now()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seeded_store_sequences_are_identical(seed):
    from repro.core.policy import Tier as JT, TieringPolicy as JP
    from repro_torch.core.policy import Tier as TT, TieringPolicy as TP
    a = _drive(JStore, JSpec, JClock, JP, JT, seed)
    b = _drive(TStore, TSpec, TClock, TP, TT, seed)
    assert a[0] == b[0]           # values, clock times, tiers, reports
    assert a[1] == b[1]           # TierStats
    assert a[2] == b[2]           # QueueStats
    assert a[4] == b[4]           # final virtual-clock time
    ja, ta = a[3], b[3]
    for comp in ta:
        np.testing.assert_allclose(ta[comp], ja[comp], rtol=1e-12)
