"""The port's self-healing tier (`runtime/repair.py` behind
`Platform.repair`, and `platform/failover.py`'s kill-a-host-at-diurnal-
peak bench) against the JAX reference's.

What must match, and how closely:
  * `run_failover_bench` JSON: byte for byte (`obs.bench_json` on both
    sides);
  * every `RepairStats.as_dict()` and `FailureReport.as_dict()`: value
    for value (the same modeled Python on both sides; floats equal, not
    close), with the fabric's holders and summary after the repair.

The reference's own checks (`tests/test_self_healing.py`: the repair
loop, the failure interleavings, `Platform.fail_host`/`repair` and the
failover bench) run on the port's results. The interleaving property
runs over fixed seeded op lists, so its count is the same on every run.
Everything runs on the CPU (`device="cpu"`); chip_smoke.py phase 11
holds the CUDA run's JSON to the CPU's."""
import json

import numpy as np
import pytest
import torch

import repro.platform as JP
from repro.core.policy import Tier as JTier, TieringPolicy as JPolicy
from repro.obs import bench_json as j_bench_json
from repro.runtime import RepairLoop as JRepair
from repro.runtime import ShardedTieredStore as JFabric
from repro.runtime import VirtualClock as JClock
import repro_torch.platform as TP
from repro_torch.core.policy import Tier, TieringPolicy
from repro_torch.obs import bench_json
from repro_torch.runtime import RepairLoop, RepairStats, \
    ShardedTieredStore, VirtualClock

PORT = dict(Fabric=ShardedTieredStore, Clock=VirtualClock,
            Policy=TieringPolicy, Tier=Tier, Repair=RepairLoop)
REF = dict(Fabric=JFabric, Clock=JClock, Policy=JPolicy, Tier=JTier,
           Repair=JRepair)


def _fabric(S, n_hosts, **kw):
    def pinned(_h=0):
        return S["Policy"](tau_hot=1e-12, tau_be=1e-9, ema_alpha=1.0)
    return S["Fabric"](n_hosts, policy_factory=pinned, clock=S["Clock"](),
                       **kw)


def _state(fab, keys):
    """Where every key lives, and the fabric's counters."""
    return ({k: fab.holders(k) for k in keys}, fab.summary(),
            fab.clock.now())


# ---------------------------------------------------------------------------
# repair loop: restores the degree, paced by rebalance_rate, bounded step
# ---------------------------------------------------------------------------

def _restore(S):
    fab = _fabric(S, 4)
    keys = []
    for i in range(60):
        key = ("kv", i)
        fab.put(key, np.full(256, i, np.int32), tier=S["Tier"].FLASH,
                from_host=fab.owner(key), replicas=2)
        keys.append(key)
    fab.drain()
    report = fab.fail_host(fab.host_ids[1])
    loop = S["Repair"](fab)
    pending = list(loop.pending())
    stats = loop.run()
    left = fab.under_replicated()
    fab.drain()
    vals = [fab.get(k, from_host=fab.host_ids[0]) for k in keys]
    return fab, keys, report, pending, stats, left, vals


def test_repair_restores_replication_degree():
    fab, keys, report, pending, stats, left, vals = _restore(PORT)
    assert pending, "a failure must leave under-replicated keys"
    assert stats.keys_repaired > 0 and stats.bytes_repaired > 0
    assert stats.t_done >= stats.t_start
    assert not left
    for i, key in enumerate(keys):
        holders = fab.holders(key)
        assert len(holders) == 2
        assert holders == fab._targets(key)
        np.testing.assert_array_equal(vals[i], np.full(256, i, np.int32))
    jfab, _, jreport, jpending, jstats, _, jvals = _restore(REF)
    assert pending == jpending
    assert report.as_dict() == jreport.as_dict()
    assert stats.as_dict() == jstats.as_dict()
    assert _state(fab, keys) == _state(jfab, keys)
    for got, want in zip(vals, jvals):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("rate", [1e6, 1e9, None])
def test_repair_is_paced_by_rebalance_rate(rate):
    """Per pacer rate, the port's recovery equals the reference's; a
    slower token bucket gives a strictly later repair horizon for the
    same repair work."""
    def recovery(S, rate):
        fab = _fabric(S, 3, rebalance_rate=rate)
        for i in range(30):
            key = ("kv", i)
            fab.put(key, np.zeros(1 << 12, np.uint8), tier=S["Tier"].FLASH,
                    from_host=fab.owner(key), replicas=2)
        fab.drain()
        report = fab.fail_host(fab.host_ids[0])
        stats = S["Repair"](fab).run()
        assert not fab.under_replicated()
        return stats.t_done - report.t_fail, stats.as_dict()

    got = recovery(PORT, rate)
    assert got == recovery(REF, rate)
    if rate == 1e6:
        slow, fast = got[0], recovery(PORT, 1e9)[0]
        assert slow > fast, (slow, fast)
        # the slow-arm floor: total repaired bytes cannot stream faster
        # than the bucket refills (split across at most 2 sources)
        assert slow > (30 // 2) * (1 << 12) / 1e6 / 2


def test_repair_step_is_bounded():
    def run(S):
        fab = _fabric(S, 3)
        for i in range(20):
            key = ("kv", i)
            fab.put(key, np.zeros(128, np.uint8), tier=S["Tier"].FLASH,
                    from_host=fab.owner(key), replicas=2)
        fab.drain()
        fab.fail_host(fab.host_ids[0])
        loop = S["Repair"](fab, batch_keys=4)
        pending0 = len(loop.pending())
        steps = [loop.step().as_dict()]
        pending1 = len(loop.pending())
        while loop.pending():
            steps.append(loop.step().as_dict())
        return pending0, pending1, steps

    got = run(PORT)
    assert got == run(REF)
    pending0, pending1, steps = got
    assert steps[0]["keys_scanned"] <= 4
    assert pending1 < pending0
    assert all(s["keys_scanned"] <= 4 for s in steps)
    with pytest.raises(ValueError, match="batch_keys"):
        RepairLoop(_fabric(PORT, 2), batch_keys=0)


def test_repair_stats_as_dict():
    s = RepairStats(t_start=1.0, t_done=0.5, keys_scanned=3)
    assert s.duration == 0.0
    assert s.as_dict() == {
        "t_start": 1.0, "t_done": 0.5, "duration": 0.0,
        "keys_scanned": 3.0, "keys_repaired": 0.0, "bytes_repaired": 0.0,
        "nic_transfers": 0.0, "copies_dropped": 0.0}


# ---------------------------------------------------------------------------
# failure interleavings never lose a replicated key (fixed seeded ops)
# ---------------------------------------------------------------------------

MAX_HOSTS = 6


def _apply_failure_ops(S, ops):
    """Drive put/get/add_host/fail_host/repair while mirroring a dict
    model. `fail_host` may only lose keys that were already down to a
    single copy (a prior failure, not yet repaired); those leave the
    model via the FailureReport."""
    fab = _fabric(S, 3)
    loop = S["Repair"](fab)
    model, log = {}, []
    for code, arg in ops:
        if code in (0, 1):
            key = ("k", arg % 20)
            val = np.full(64, arg, np.int32)
            fab.put(key, val, tier=S["Tier"].FLASH,
                    from_host=fab.host_ids[arg % fab.n_hosts],
                    replicas=2)
            model[key] = val
        elif code == 2 and model:
            key = list(model)[arg % len(model)]
            got = fab.get(key, from_host=fab.host_ids[arg % fab.n_hosts])
            np.testing.assert_array_equal(got, model[key])
        elif code == 3 and fab.n_hosts < MAX_HOSTS:
            log.append(fab.add_host().as_dict())
        elif code == 4 and fab.n_hosts > 1:
            victim = fab.host_ids[arg % fab.n_hosts]
            at_risk = {k for k in model if len(fab.holders(k)) <= 1}
            report = fab.fail_host(victim)
            lost = set(report.lost_keys)
            # a key with >= 2 live copies is NEVER lost
            assert lost <= at_risk, (lost, at_risk)
            for key in lost:
                model.pop(key, None)
            log.append(report.as_dict())
        elif code == 5:
            log.append(loop.run().as_dict())
    return fab, loop, model, log


def _ops(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 25))
    return [(int(c), int(a)) for c, a in zip(rng.integers(0, 6, n),
                                             rng.integers(0, 1001, n))]


# seeds 0-9 draw random interleavings; the last two lists pin a double
# failure before any repair and a failure right after a join
FIXED_OPS = [_ops(seed) for seed in range(10)] + [
    [(0, 1), (1, 2), (0, 3), (4, 0), (4, 1), (5, 0), (2, 1)],
    [(0, 7), (3, 0), (4, 3), (1, 8), (5, 0), (3, 0), (4, 0), (2, 0)],
]


@pytest.mark.parametrize("ops", FIXED_OPS,
                         ids=[f"seed{i}" for i in range(10)]
                         + ["double_fail", "fail_after_join"])
def test_failure_interleavings_never_lose_replicated_keys(ops):
    fab, loop, model, log = _apply_failure_ops(PORT, ops)
    # repair converges: every surviving key back at declared degree
    log.append(loop.run().as_dict())
    fab.drain()
    state = _state(fab, sorted(model))
    assert not fab.under_replicated()
    for key, val in model.items():
        holders = fab.holders(key)
        want = min(2, fab.n_hosts)
        assert len(holders) == want, (key, holders)
        assert holders == fab._targets(key)
        got = fab.get(key, from_host=fab.host_ids[0])
        np.testing.assert_array_equal(got, val)
    live = {k for s in fab.hosts.values() for k in s.keys()}
    assert live == set(model)
    # the reference walks the same ops to the same state
    jfab, jloop, jmodel, jlog = _apply_failure_ops(REF, ops)
    jlog.append(jloop.run().as_dict())
    jfab.drain()
    assert log == jlog
    assert model.keys() == jmodel.keys()
    assert state == _state(jfab, sorted(jmodel))


# ---------------------------------------------------------------------------
# Platform.fail_host / Platform.repair
# ---------------------------------------------------------------------------

def test_platform_fail_and_repair_capabilities():
    def run(P, tier, **kw):
        spec = P.HierarchySpec(
            hosts=(P.HostDecl(count=3),),
            policy=P.PolicyDecl.static(tau_hot=1e-12, tau_be=1e-9),
            replicas=2)
        platform = P.Platform.compile(spec, **kw)
        fab = platform.fabric
        keys = [("kv", i) for i in range(12)]
        for key in keys:
            fab.put(key, np.zeros(128, np.uint8), tier=tier,
                    from_host=fab.owner(key), replicas=2)
        fab.drain()
        report = platform.fail_host(fab.host_ids[0])
        stats = platform.repair()
        left = fab.under_replicated()
        # availability pricing needs the economic policy
        with pytest.raises(ValueError, match="advisor"):
            platform.advise_availability(mttf=100.0)
        return report, stats, left, _state(fab, keys)

    report, stats, left, state = run(TP, Tier.FLASH, device="cpu")
    assert report.keys_lost == 0
    assert stats.keys_repaired > 0
    assert not left
    jreport, jstats, _, jstate = run(JP, JTier.FLASH)
    assert report.as_dict() == jreport.as_dict()
    assert stats.as_dict() == jstats.as_dict()
    assert state == jstate


def test_platform_repair_batches_like_the_reference():
    """`Platform.repair(batch_keys=)` re-scans between batches and
    converges to the same placement and stats as the reference's."""
    def run(P, **kw):
        spec = P.HierarchySpec(
            hosts=(P.HostDecl(count=4),),
            policy=P.PolicyDecl.economic(l_blk=1 << 12),
            replicas=2, rebalance_rate=1e8, mttf=600.0)
        platform = P.Platform.compile(spec, **kw)
        fab = platform.fabric
        keys = [("kv", i) for i in range(40)]
        for key in keys:
            fab.put(key, np.zeros(1 << 10, np.float32),
                    from_host=fab.owner(key), replicas=2)
        platform.clock.advance(0.5)
        fab.drain()
        report = platform.fail_host(2)
        stats = platform.repair(batch_keys=3)
        avail = platform.advise_availability().as_dict()
        return report.as_dict(), stats.as_dict(), avail, \
            _state(fab, keys)

    got = run(TP, device="cpu")
    assert got == run(JP)
    assert got[1]["keys_repaired"] > 3
    assert got[2]["n_hosts"] == 3


# ---------------------------------------------------------------------------
# the kill-a-host-at-diurnal-peak bench
# ---------------------------------------------------------------------------

def test_failover_bench_acceptance_and_determinism():
    """With replicas>=2 and checkpointing on, zero committed keys lost
    and every session resumes; the advisor's recommended replication
    factor beats both r=1 and r=3 on measured $/token; byte-identical
    across in-process double runs and to the reference."""
    kw = dict(n_steps=100, n_sessions=8)
    out = TP.run_failover_bench(device="cpu", **kw)
    assert out["zero_committed_loss_replicated"]
    assert out["all_sessions_resume_replicated"]
    rec = int(out["recommended_replicas"])
    assert rec == 2
    assert out["recommended_wins"]
    cpt = {r: arm["cost_per_token"] for r, arm in out["arms"].items()}
    assert cpt[str(rec)] < cpt["1"] and cpt[str(rec)] < cpt["3"]
    # unreplicated really does lose data at the kill (the bench bites)
    assert out["arms"]["1"]["committed_keys_lost"] > 0
    assert out["arms"]["2"]["recovery_seconds"] > 0
    again = TP.run_failover_bench(device="cpu", **kw)
    assert json.dumps(out, sort_keys=True) == \
        json.dumps(again, sort_keys=True)
    assert bench_json(out) == j_bench_json(JP.run_failover_bench(**kw))


def test_failover_bench_at_reference_defaults():
    """Four hosts, 12 sessions, the kill at step 120 of 240."""
    out = TP.run_failover_bench(device="cpu")
    assert bench_json(out) == j_bench_json(JP.run_failover_bench())
    arms = out["arms"]
    assert out["params"]["kill_step"] == 120
    assert int(out["recommended_replicas"]) == 2
    assert (arms["1"]["committed_keys_lost"], arms["1"]["sessions_lost"]) \
        == (16.0, 5.0)
    assert (arms["2"]["committed_keys_lost"], arms["2"]["sessions_lost"],
            arms["2"]["sessions_resumed"]) == (0.0, 0.0, 3.0)
    assert round(arms["2"]["recovery_seconds"] * 1e3, 2) == 2.25
    assert round(arms["3"]["cost_per_token"], 6) == 0.000246
    assert round(arms["2"]["cost_per_token"], 6) == 0.000181


@pytest.mark.parametrize("kw", [
    dict(n_steps=60, n_sessions=4, kill_at_frac=0.25),
    dict(n_steps=60, n_sessions=6, checkpoint_every=0, mttf=1e9),
    dict(n_steps=60, n_sessions=4, scenario="zipf"),
], ids=["early_kill", "no_checkpoints", "zipf"])
def test_failover_bench_matches_reference_off_defaults(kw):
    got = TP.run_failover_bench(device="cpu", **kw)
    assert bench_json(got) == j_bench_json(JP.run_failover_bench(**kw))


def test_failover_spec_json_matches_reference():
    assert TP.default_failover_spec(replicas=2).to_json() == \
        JP.default_failover_spec(replicas=2).to_json()


def test_failover_bench_needs_a_device_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TP.run_failover_bench(n_steps=10, n_sessions=2)
