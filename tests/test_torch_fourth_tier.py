"""The port's fourth tier against the JAX reference's: the fleet-shared
far-memory pool (`runtime/pool.py` with `PoolLaneModel`), the GPU-direct
flash tier of `TieredStore` and its `AsyncTierRuntime` lane, the fabric's
pool paths, `Platform.compile` with `pool=` and "gpu_flash" hosts, and
the fourth-tier bench (`serving/tiers.py`) with its twin
(`python -m repro_torch.benchmarks.serving_tiers`).

The runtime is the same modeled Python on both sides, so every modeled
record must match exactly: the scenarios of the reference's
tests/test_fourth_tier.py run on both packages and their records
(virtual-clock times, stats, ledgers, residency, raised messages) are
equal. `run_tiers_bench(smoke=True)` on the reference's PRNGKey(0)
weights (through `params_from_jax`, on the CPU) returns the reference's
dict key for key and float for float, and the twin's `--smoke` JSON and
`--out` file equal the reference script's byte for byte (its stderr
line for line). The reference script runs once (a module-scoped
fixture)."""
import contextlib
import dataclasses
import functools
import io
import json
import pathlib
import runpy
import sys
import types

import jax
import numpy as np
import pytest

import repro.autopilot.gate as j_gate
import repro.core.policy as j_policy
import repro.obs.ledger as j_ledger
import repro.platform as j_platform
import repro.runtime as j_rt
import repro.serving.tiers as jtiers
import repro_torch.autopilot.gate as t_gate
import repro_torch.core.policy as t_policy
import repro_torch.obs.ledger as t_ledger
import repro_torch.platform as t_platform
import repro_torch.runtime as t_rt
from repro.configs import get_config as j_get_config
from repro.models import model as JM
from repro_torch.benchmarks import serving_tiers as twin
from repro_torch.configs import get_config
from repro_torch.models import model as TM
from repro_torch.serving import tiers as ttiers

ROOT = pathlib.Path(__file__).resolve().parents[1]
RT_NAMES = ("PooledStore", "PoolLaneModel", "ShardedTieredStore",
            "TieredStore", "TierSpec", "VirtualClock")


def _ns(policy, gate, ledger, rt, platform, compile_):
    return types.SimpleNamespace(
        Tier=policy.Tier, EconomicGate=gate,
        COMPONENTS=ledger.COMPONENTS, P=platform, compile=compile_,
        **{n: getattr(rt, n) for n in RT_NAMES})


REF = _ns(j_policy, j_gate.EconomicGate, j_ledger, j_rt, j_platform,
          j_platform.Platform.compile)
# the port's gates keep their reuse sketch on a device: the CPU here
PORT = _ns(t_policy, functools.partial(t_gate.EconomicGate, device="cpu"),
           t_ledger, t_rt, t_platform,
           lambda spec: t_platform.Platform.compile(spec, device="cpu"))


def _both(fn, *args, **kw):
    """fn on the reference and the port; the records must be equal. The
    port's is returned."""
    want, got = fn(REF, *args, **kw), fn(PORT, *args, **kw)
    assert json.dumps(got, sort_keys=True, default=repr) == json.dumps(
        want, sort_keys=True, default=repr)
    assert got == want
    return got


def _raised(fn):
    try:
        fn()
    except Exception as e:          # the record is the type and message
        return [type(e).__name__, str(e)]
    return None


# ---------------------------------------------------------------------------
# PooledStore: readability, LRU spill, oversize, byte-seconds, fate-sharing
# ---------------------------------------------------------------------------

def _pool(ns, clock, cap_blobs=4, **kw):
    pool = ns.PooledStore(cap_blobs * 1024.0, clock=clock,
                          **{**dict(read_bw=1e6, write_bw=1e6, rtt=1e-3),
                             **kw})
    pool.attach_host(0)
    pool.attach_host(1)
    return pool


def _readability(ns):
    clock = ns.VirtualClock()
    pool = _pool(ns, clock)
    blob = np.arange(1024, dtype=np.uint8)
    tr = pool.put("k", blob, from_host=0)
    issued = clock.now()
    got = pool.get("k", from_host=1)        # issued before arrival
    assert tr.done_t > issued and clock.now() >= tr.done_t - 1e-12
    assert pool.stats.stall_time > 0
    return {"done_t": tr.done_t, "now": clock.now(),
            "bytes": got.tobytes() == blob.tobytes(),
            "stats": pool.snapshot_stats(), "report": pool.report(),
            "ledger": pool.ledger.as_dict()}


def _lru_spill(ns):
    clock = ns.VirtualClock()
    pool = _pool(ns, clock, cap_blobs=2)
    spilled = []
    pool.on_evict = lambda k, v, owner: spilled.append([k, owner])
    pool.put("a", np.zeros(1024, np.uint8), from_host=0)
    clock.advance(1.0)
    pool.put("b", np.zeros(1024, np.uint8), from_host=1)
    clock.advance(1.0)
    pool.get("a", from_host=0)              # refresh a; b is now LRU
    pool.put("c", np.zeros(1024, np.uint8), from_host=0)
    assert spilled == [["b", 1]]
    return {"spilled": spilled, "keys": pool.keys(),
            "stats": pool.snapshot_stats(), "now": clock.now()}


def _oversized(ns):
    pool = _pool(ns, ns.VirtualClock(), cap_blobs=1)
    return _raised(lambda: pool.put("big", np.zeros(4096, np.uint8),
                                    from_host=0))


def _byte_seconds(ns):
    clock = ns.VirtualClock()
    pool = _pool(ns, clock)
    pool.put("k", np.zeros(1024, np.uint8), from_host=0)
    out = [pool.byte_seconds()]
    clock.advance(2.0)
    out.append(pool.byte_seconds())
    pool.delete("k")
    out.append(pool.byte_seconds())
    clock.advance(10.0)                     # nothing resident: no accrual
    out.append(pool.byte_seconds())
    assert out[1] - out[0] == pytest.approx(1024 * 2.0)
    assert out[3] == pytest.approx(out[2], rel=1e-12)
    return out


def _fate_sharing(ns):
    clock = ns.VirtualClock()
    pool = _pool(ns, clock)
    pool.put("k", np.zeros(1024, np.uint8), from_host=0)
    pool.detach_host(0)
    assert pool.has("k")                    # residency survives the host
    return {"dead_lane": _raised(lambda: pool.get("k", from_host=0)),
            "alive": int(pool.get("k", from_host=1).nbytes),
            "lanes": sorted(pool.lanes), "now": clock.now(),
            "stats": pool.snapshot_stats()}


def _pool_rtt(ns):
    clock = ns.VirtualClock()
    pool = _pool(ns, clock)
    pool.put("k", np.zeros(4096, np.uint8), from_host=0)
    pool.get("k", from_host=1)
    led = pool.ledger.as_dict()
    assert led["pool_rtt"] > 0
    assert all(led[c] == 0.0 for c in ns.COMPONENTS
               if c not in ("pool_rtt", "interference"))
    return led


@pytest.mark.parametrize("scenario", [
    _readability, _lru_spill, _oversized, _byte_seconds, _fate_sharing,
    _pool_rtt], ids=lambda f: f.__name__.strip("_"))
def test_pooled_store_matches_reference(scenario):
    got = _both(scenario)
    if scenario is _oversized:
        assert got[0] == "ValueError" and "exceeds the pool capacity" \
            in got[1]
    if scenario is _fate_sharing:
        assert got["dead_lane"][0] == "KeyError" \
            and "no pool lane" in got["dead_lane"][1]


@pytest.mark.parametrize("write", [False, True], ids=["read", "write"])
@pytest.mark.parametrize("depth", [1, 2, 4, 9])
def test_pool_lane_model_matches_reference(write, depth):
    def svc(ns):
        s = ns.PoolLaneModel(rtt=3e-6, read_bw=40e9,
                             write_bw=10e9).service(1 << 20, depth,
                                                    write=write)
        return [s.occupancy, s.latency]
    _both(svc)
    assert _both(lambda ns: _raised(lambda: ns.PoolLaneModel(
        read_bw=1e9, write_bw=-1.0)))[0] == "ValueError"


# ---------------------------------------------------------------------------
# the fabric with a pool: gate-driven pooling, promotion, host failure
# ---------------------------------------------------------------------------

def _fabric_with_pool(ns, n_hosts=3, tau_pool=8.0, dram_blobs=4):
    clock = ns.VirtualClock()
    pool = ns.PooledStore(64 * 1024.0, read_bw=1e9, rtt=1e-5, clock=clock)
    specs = {
        ns.Tier.DRAM: ns.TierSpec(dram_blobs * 1024.0, 45e9, 5e-7),
        ns.Tier.FLASH: ns.TierSpec(float(1 << 30), 7e9, 2e-5),
    }
    fab = ns.ShardedTieredStore(
        n_hosts,
        policy_factory=lambda h: ns.EconomicGate(
            tau_hot=0.05, tau_be=2.0, tau_pool=tau_pool),
        specs=specs, clock=clock, pool=pool)
    return fab, clock


def _teach_fabric(fab, key, interval, *, reps=3, host=0):
    for _ in range(reps):
        fab.hosts[host].policy.observe(key, now=fab.clock.now())
        fab.clock.advance(interval)


def _fabric_record(fab, keys):
    return {"tiers": [None if fab.tier_of(k) is None else int(fab.tier_of(k))
                      for k in keys],
            "summary": fab.summary(), "snapshot": fab.snapshot_stats(),
            "now": fab.clock.now(), "pool_keys": fab.pool.keys()
            if fab.pool is not None else None}


def _pool_and_promote(ns):
    fab, clock = _fabric_with_pool(ns)
    blob = np.arange(1024, dtype=np.uint8)
    _teach_fabric(fab, "band", 4.0)
    fab.put("band", blob, tier=ns.Tier.DRAM, from_host=0)
    assert fab.tier_of("band") == ns.Tier.POOL and fab.pool_puts == 1
    pooled = _fabric_record(fab, ["band"])
    est = fab.estimate_fetch_seconds("band", from_host=2)
    # reuse at a DRAM-worthy cadence: the fetch observes, the policy now
    # wants it warm, and the fabric promotes it out of the pool
    waits = []
    for _ in range(4):
        clock.advance(0.5)
        got = fab.get("band", from_host=1)
        waits.append(clock.now())
    assert got.tobytes() == blob.tobytes()
    assert fab.pool.stats.promotions >= 1 and not fab.pool.has("band")
    assert fab.hosts[1].tier_of("band") is not None
    return {"pooled": pooled, "est": est, "waits": waits,
            "after": _fabric_record(fab, ["band"]),
            "fetches": fab.pool_fetches}


def _survives_failure(ns):
    fab, clock = _fabric_with_pool(ns)
    _teach_fabric(fab, "band", 4.0)
    fab.put("band", np.ones(1024, np.uint8), tier=ns.Tier.DRAM,
            from_host=0)
    assert fab.tier_of("band") == ns.Tier.POOL
    report = fab.fail_host(0)
    # fleet infrastructure: residency survives; the dead host's lane does
    # not, but any surviving host still reaches the bytes
    assert fab.pool.has("band") and 0 not in fab.pool.lanes
    got = fab.get("band", from_host=1)
    assert int(got[0]) == 1
    return {"report": dataclasses.asdict(report)
            if dataclasses.is_dataclass(report) else repr(report),
            "lanes": sorted(fab.pool.lanes),
            "after": _fabric_record(fab, ["band"])}


def _pool_spill_and_join(ns):
    """A small pool under pressure spills its LRU blob to its pooling
    host's flash; a joining host gets a lane; the drain waits the pool."""
    fab, clock = _fabric_with_pool(ns)
    fab.pool.capacity_bytes = 2 * 1024.0
    keys = [f"band{i}" for i in range(3)]
    for i, k in enumerate(keys):
        _teach_fabric(fab, k, 4.0, host=i % 3)
        fab.put(k, np.full(1024, i, np.uint8), tier=ns.Tier.DRAM,
                from_host=i % 3)
    assert fab.pool.stats.evictions == 1
    joined = dataclasses.asdict(fab.add_host())
    h = joined["host"]
    assert h in fab.pool.lanes
    drained = fab.drain()
    return {"added": joined, "lanes": sorted(fab.pool.lanes), "drain": drained,
            "owners": [fab.owner(k) for k in keys],
            "after": _fabric_record(fab, keys)}


def _without_pool(ns):
    """A 3-tier fleet (pool=None) with a four-tier-capable gate: no
    pooling, no pool counters."""
    clock = ns.VirtualClock()
    fab = ns.ShardedTieredStore(
        2, policy_factory=lambda h: ns.EconomicGate(
            tau_hot=0.05, tau_be=2.0, tau_pool=8.0),
        clock=clock)
    _teach_fabric(fab, "band", 4.0)
    fab.put("band", np.zeros(1024, np.uint8), tier=ns.Tier.DRAM,
            from_host=0)
    assert fab.tier_of("band") in (ns.Tier.DRAM, ns.Tier.FLASH)
    assert fab.pool_puts == 0 and fab.pool_fetches == 0
    return _fabric_record(fab, ["band"])


@pytest.mark.parametrize("scenario", [
    _pool_and_promote, _survives_failure, _pool_spill_and_join,
    _without_pool], ids=lambda f: f.__name__.strip("_"))
def test_fabric_pool_matches_reference(scenario):
    got = _both(scenario)
    if scenario is _pool_and_promote:
        assert got["after"]["snapshot"]["pool"]["promotions"] >= 1
        assert got["after"]["summary"]["pool_fetches"] >= 1.0
        assert got["after"]["snapshot"]["counters"]["pool_puts"] == 1


# ---------------------------------------------------------------------------
# TieredStore's fourth tier: the GPU-direct lane
# ---------------------------------------------------------------------------

def _gpu_store(ns):
    T = ns.Tier
    clock = ns.VirtualClock()
    specs = {T.DRAM: ns.TierSpec(2 * 4096.0, 45e9, 5e-7),
             T.FLASH: ns.TierSpec(float(1 << 30), 7e9, 2e-5),
             T.GPU_FLASH: ns.TierSpec(float(1 << 30), 7e9, 2e-5)}
    store = ns.TieredStore(ns.EconomicGate(tau_hot=0.05, tau_be=2.0,
                                           gpu_direct=True),
                           specs=specs, clock=clock)
    return store, clock


def _gpu_flash_lane(ns):
    T = ns.Tier
    store, clock = _gpu_store(ns)
    store.put("g", np.zeros(4096, np.uint8), tier=T.GPU_FLASH)
    store.put("f", np.zeros(4096, np.uint8), tier=T.FLASH)
    # warm-tier overflow falls to FLASH, never sideways to GPU_FLASH
    for i in range(4):
        store.put(f"d{i}", np.zeros(4096, np.uint8), tier=T.DRAM)
    clock.advance(1.0)
    for k in ("g", "f"):
        store.get(k)
    led = store.runtime.ledger.as_dict()
    assert led["gpu_direct_service"] > 0 and led["flash_service"] > 0
    assert type(store.runtime.models[T.GPU_FLASH]).__name__ \
        == "GpuDirectQueueModel"
    return {"tiers": {k: int(store.tier_of(k))
                      for k in ["g", "f"] + [f"d{i}" for i in range(4)]},
            "ledger": led, "now": clock.now(),
            "stats": {int(t): dataclasses.asdict(s)
                      for t, s in store.stats.items()},
            "est": store.estimate_fetch_seconds("g")}


def _gate_cold_to_gpu_flash(ns):
    """A gate-cold DRAM ask on a gpu_direct gate lands on GPU_FLASH; its
    restore bills gpu_direct_service, never gate_miss_restore."""
    T = ns.Tier
    store, clock = _gpu_store(ns)
    for _ in range(3):
        store.policy.observe("cold", now=clock.now())
        clock.advance(30.0)
    store.put("cold", np.zeros(4096, np.uint8), tier=T.DRAM)
    assert store.tier_of("cold") == T.GPU_FLASH
    store.get("cold")
    led = store.runtime.ledger.as_dict()
    assert led["gate_miss_restore"] == 0.0 and led["gpu_direct_service"] > 0
    return {"ledger": led, "gate": dataclasses.asdict(
        store.policy.gate_stats), "now": clock.now()}


@pytest.mark.parametrize("scenario", [_gpu_flash_lane,
                                      _gate_cold_to_gpu_flash],
                         ids=lambda f: f.__name__.strip("_"))
def test_gpu_flash_tier_matches_reference(scenario):
    _both(scenario)


# ---------------------------------------------------------------------------
# Platform.compile with pool= and "gpu_flash" hosts
# ---------------------------------------------------------------------------

L_BLK = 32768


def _four_tier_spec(P, pool_cap=1 << 22, rent_factor=0.25, rtt=2e-6,
                    read_bw=40e9):
    return P.HierarchySpec(
        hosts=(P.HostDecl(count=2, tiers={
            "dram": P.TierDecl(1 << 20, 45e9, 5e-7),
            "gpu_flash": P.gpu_flash_tier(),
        }), P.HostDecl(tiers={"dram": P.TierDecl(1 << 20, 45e9, 5e-7)})),
        policy=P.PolicyDecl.economic(l_blk=L_BLK),
        pool=P.PoolDecl(capacity_bytes=float(pool_cap), read_bw=read_bw,
                        rent_factor=rent_factor, rtt=rtt),
        step_time=0.25)


def _compiled(ns, **kw):
    spec = ns.P.HierarchySpec.from_json(
        _four_tier_spec(REF.P, **kw).to_json())
    plat = ns.compile(spec)
    gates = [plat.policy(h) for h in range(plat.n_hosts)]
    rec = {"tau_be": [g.tau_be for g in gates],
           "tau_pool": [g.tau_pool for g in gates],
           "gpu_direct": [g.gpu_direct for g in gates],
           "pool": None if plat.fabric.pool is None else
           [plat.fabric.pool.capacity_bytes, sorted(plat.fabric.pool.lanes),
            plat.fabric.pool.rent_factor],
           "tiers": [sorted(int(t) for t in plat.fabric.hosts[h].specs)
                     for h in range(plat.n_hosts)]}
    # the gate's four-way decisions on taught intervals, host 0
    g, decisions, t = gates[0], {}, 0.0
    for key, interval in (("hot", 0.5), ("band", 4.0), ("cold", 30.0)):
        for _ in range(3):
            g.observe(key, now=t)
            t += interval
        decisions[key] = [int(g.admit_tier(key, ns.Tier.DRAM, t)),
                          bool(g.pool_admit(key, ns.Tier.DRAM, t))]
    rec["decisions"] = decisions
    rec["gate_stats"] = dataclasses.asdict(g.gate_stats)
    h = plat.add_host().host
    rec["joined"] = [h, plat.policy(h).gpu_direct,
                     sorted(plat.fabric.pool.lanes)
                     if plat.fabric.pool is not None else None]
    return rec


def test_compiled_four_tier_platform_matches_reference():
    got = _both(_compiled)
    assert got["gpu_direct"] == [True, True, False]
    assert got["tau_pool"][0] is not None \
        and got["tau_pool"][0] > got["tau_be"][0]
    assert got["pool"][1] == [0, 1, 2]
    assert got["decisions"]["band"][1]
    assert got["decisions"]["cold"][0] == int(PORT.Tier.GPU_FLASH)


def test_narrow_band_compiles_pool_without_gate_band():
    """A pool whose crossover falls at or under tau_be still compiles (the
    slab exists) but no gate gets a band."""
    got = _both(_compiled, read_bw=2e8, rtt=5e-3, rent_factor=0.95)
    assert got["pool"] is not None and got["tau_pool"] == [None] * 3


def test_advise_tiers_defaults_to_the_declared_pool():
    def advise(ns):
        plat = ns.compile(ns.P.HierarchySpec.from_json(
            _four_tier_spec(REF.P).to_json()))
        kv = plat.kv_session("u", host=0)
        for _ in range(3):
            kv.save(np.zeros(L_BLK, np.uint8))
            plat.clock.advance(4.0)
        return plat.advise_tiers(access_rate=10.0).as_dict()
    got = _both(advise)
    assert set(got["arms"]) == {"baseline", "gpu_flash", "pool", "both"}


# ---------------------------------------------------------------------------
# run_tiers_bench and the twin
# ---------------------------------------------------------------------------

def _run(fn):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        fn()
    return out.getvalue(), err.getvalue().splitlines()


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    """The reference script `--smoke` (runpy) and the twin `--smoke
    --device cpu` with the reference's weights: (stdout, stderr lines,
    --out bytes, the dict run_tiers_bench returned) each."""
    jcfg, cfg = (j_get_config("gemma-2b", reduced=True),
                 get_config("gemma-2b", reduced=True))
    jp, _ = JM.init_params(jax.random.PRNGKey(0), jcfg)
    params = TM.params_from_jax(jax.tree.map(np.asarray, jp), cfg,
                                device="cpu")
    base = tmp_path_factory.mktemp("tiers")
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        for side in ("ref", "port"):
            out_path = base / f"{side}.json"
            got = {}
            if side == "port":
                inner = ttiers.run_tiers_bench

                def noted(*a, **k):
                    got["r"] = inner(*a, params=params, **k)
                    return got["r"]
                mp.setattr(twin, "run_tiers_bench", noted)
                io_ = _run(lambda: twin.main(["--smoke", "--device", "cpu",
                                              "--out", str(out_path)]))
            else:
                inner_ref = jtiers.run_tiers_bench

                def noted_ref(*a, **k):
                    got["r"] = inner_ref(*a, **k)
                    return got["r"]
                mp.setattr(jtiers, "run_tiers_bench", noted_ref)
                mp.setattr(sys, "argv", ["serving_tiers.py", "--smoke",
                                         "--out", str(out_path)])
                io_ = _run(lambda: runpy.run_path(
                    str(ROOT / "benchmarks" / "serving_tiers.py"),
                    run_name="__main__"))
            runs[side] = (*io_, out_path.read_bytes(), got["r"])
    return runs


def test_run_tiers_bench_matches_reference(sides):
    """run_tiers_bench(smoke=True)'s dict on the reference's weights, and
    the reference test's headline (tests/test_fourth_tier.py::
    test_tiers_bench_headline_and_conservation)."""
    got, want = sides["port"][3], sides["ref"][3]
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)
    assert got == want
    assert got["gpu_flash_wins_somewhere"] and got["pool_wins_somewhere"]
    for scen in ("moe_scan", "diurnal"):
        cell = got[scen]
        assert cell["advice_agreement"], cell["advice"]
        for arm in ttiers.ARM_ORDER:
            m = cell[arm]["report"]
            led = m["stall_ledger"]
            assert set(t_ledger.COMPONENTS) <= set(led)
            rhs = m["per_token_stall"] * max(m["tokens"], 1)
            assert abs(led["total"] - rhs) <= 1e-9 * max(rhs, 1e-30)
        assert cell["gpu_flash"]["gate"]["admits_gpu_flash"] > 0
    assert got["diurnal"]["pool"]["gate"]["admits_pool"] > 0
    assert got["diurnal"]["pool"]["pool_stats"]["puts"] > 0
    assert got["diurnal"]["advice"]["recommended_arm"] in ("pool", "both")
    assert got["moe_scan"]["advice"]["recommended_arm"] in ("gpu_flash",
                                                            "both")


def test_run_tiers_bench_defaults_are_the_smoke_call():
    """The twin's --smoke call (explicit packs and pool) and
    run_tiers_bench(smoke=True) price the same packs."""
    assert {k: v.to_json() for k, v in
            ttiers.scenario_packs(smoke=True).items()} == \
        {k: v.to_json() for k, v in
         jtiers.scenario_packs(smoke=True).items()}
    assert dataclasses.asdict(ttiers.default_pool_decl()) == \
        dataclasses.asdict(jtiers.default_pool_decl())
    for kw in ({}, dict(moe_sessions=3, dram_blobs=2, seed=5)):
        assert ttiers.moe_scan_pack(**kw).to_json() == \
            jtiers.moe_scan_pack(**kw).to_json()
    assert ttiers.diurnal_pack(night_sessions=2).to_json() == \
        jtiers.diurnal_pack(night_sessions=2).to_json()


def test_tiers_twin_byte_identical(sides):
    out, err, blob, _ = sides["port"]
    ref_out, ref_err, ref_blob, _ = sides["ref"]
    assert blob == ref_blob
    assert out == ref_out
    assert err == ref_err
    assert err[-2:] == ["gpu_flash wins somewhere: True",
                        "pool wins somewhere:      True"]


def test_tiers_twin_native_weights_give_the_same_json(sides, tmp_path):
    """The twin as a user runs it, on its own seed-0 weights drawn on the
    CPU: the same bytes (the JSON holds no token)."""
    out, _ = _run(lambda: twin.main(["--smoke", "--device", "cpu", "--out",
                                     str(tmp_path / "native.json")]))
    assert (tmp_path / "native.json").read_bytes() == sides["ref"][2]
    assert out == sides["ref"][0]


def test_tiers_twin_refuses_without_cuda(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        twin.main(["--smoke"])
    with pytest.raises(SystemExit):
        with contextlib.redirect_stderr(io.StringIO()):
            twin.main(["--smoke", "--device", "tpu"])
