"""The PyTorch port's sharded fabric against the JAX reference's.

The fabric, its NIC service models and the tiered store's rebalance
ingest are the same modeled Python on both sides, so every modeled
record must match exactly: ring owners are equal integer arrays,
completion times, summaries and stats are equal floats (byte identity
of the modeled virtual clock), and failure / rebalance reports are
equal dicts. Inputs come from numpy seeds."""
import dataclasses
import types

import numpy as np
import pytest

import repro.core.policy as j_policy
import repro.obs as j_obs
import repro.runtime as j_rt
import repro_torch.core.policy as t_policy
import repro_torch.obs as t_obs
import repro_torch.runtime as t_rt

REF = types.SimpleNamespace(Tier=j_policy.Tier,
                            TieringPolicy=j_policy.TieringPolicy,
                            Observability=j_obs.Observability, **{
                                n: getattr(j_rt, n) for n in (
                                    "ShardedTieredStore", "VirtualClock",
                                    "NetQueueModel", "FabricTopology",
                                    "TieredStore", "TierSpec",
                                    "AsyncTierRuntime", "PooledStore")})
PORT = types.SimpleNamespace(Tier=t_policy.Tier,
                             TieringPolicy=t_policy.TieringPolicy,
                             Observability=t_obs.Observability, **{
                                 n: getattr(t_rt, n) for n in (
                                     "ShardedTieredStore", "VirtualClock",
                                     "NetQueueModel", "FabricTopology",
                                     "TieredStore", "TierSpec",
                                     "AsyncTierRuntime", "PooledStore")})
SIDES = (REF, PORT)


def _pinned(ns, tau_be=1e-9):
    return lambda _h: ns.TieringPolicy(tau_hot=1e-12, tau_be=tau_be,
                                       ema_alpha=1.0)


def _keys(n, seed=0):
    rng = np.random.default_rng(seed)
    return [("kv", f"s{int(i)}") for i in rng.integers(0, 10**9, n)]


def _both(fn, *args, **kw):
    return fn(REF, *args, **kw), fn(PORT, *args, **kw)


# ---------------------------------------------------------------------------
# the weighted blake2b ring
# ---------------------------------------------------------------------------

def _owners(ns, weights, change):
    fab = ns.ShardedTieredStore(len(weights), weights=weights,
                                clock=ns.VirtualClock(),
                                policy_factory=_pinned(ns))
    if change == "add":
        fab.add_host(weight=2.0)
    elif change == "fail":
        fab.fail_host(1)
    keys = _keys(1000, seed=1)
    digests = fab.key_digest_batch(keys)
    return {"batch": fab.owner_batch(keys),
            "digests": digests,
            "from_digests": fab.owner_batch(digests=digests),
            "scalar": np.array([fab.owner(k) for k in keys]),
            "rings": [fab.ring_hosts(k) for k in keys[:50]]}


@pytest.mark.parametrize("weights", [[1.0, 1.0, 1.0], [2.0, 1.0, 1.0]],
                         ids=["equal", "2to1"])
@pytest.mark.parametrize("change", [None, "add", "fail"])
def test_owner_batch_matches_reference(weights, change):
    ref, port = _both(_owners, weights, change)
    for name in ("batch", "digests", "from_digests", "scalar"):
        np.testing.assert_array_equal(port[name], ref[name], err_msg=name)
        assert port[name].dtype == ref[name].dtype
    np.testing.assert_array_equal(port["batch"], port["scalar"])
    assert port["rings"] == ref["rings"]
    if weights[0] == 2.0 and change is None:
        share = np.bincount(port["batch"], minlength=3) / 1000
        assert share[0] > share[1] and share[0] > share[2]


# ---------------------------------------------------------------------------
# a seeded put / get_async / wait schedule
# ---------------------------------------------------------------------------

def _schedule(ns, replicas, topology, seed=3):
    rng = np.random.default_rng(seed)
    clock = ns.VirtualClock()
    kw = {}
    if topology:
        kw["topology"] = ns.FabricTopology(hosts_per_rack=2,
                                           incast_degree=2)
    obs = ns.Observability()
    fab = ns.ShardedTieredStore(4, clock=clock, obs=obs,
                                policy_factory=_pinned(ns, tau_be=1.0),
                                **kw)
    keys = _keys(24, seed)
    for k in keys:
        nbytes = int(rng.integers(1, 64)) << 12
        fab.put(k, np.zeros(nbytes // 4, np.float32),
                tier=ns.Tier.FLASH if rng.random() < 0.5 else ns.Tier.DRAM,
                from_host=int(rng.integers(0, 4)), replicas=replicas)
    rec = {"done": [], "issue": [], "hosts": [], "prefer": [], "est": []}
    for _ in range(6):
        clock.advance(float(rng.uniform(0.01, 0.5)))
        batch = [keys[int(i)] for i in rng.integers(0, len(keys), 5)]
        hosts = [int(h) for h in rng.integers(0, 4, 5)]
        rec["est"] += [fab.estimate_fetch_seconds(k, from_host=h)
                       for k, h in zip(batch, hosts)]
        rec["prefer"] += [fab.preferred_host(k, default=-1) for k in batch]
        pfs = [fab.get_async(k, from_host=h) for k, h in zip(batch, hosts)]
        rec["hosts"] += [type(pf).__name__ for pf in pfs]
        clock.advance(float(rng.uniform(0.0, 2e-3)))
        for pf in pfs:
            t0 = clock.now()
            pf.wait()
            rec["issue"].append(t0)
            rec["done"].append(clock.now())
        # re-put half the batch: a new blob lands where the policy says
        for k in batch[::2]:
            fab.put(k, np.zeros(1 << 12, np.float32), from_host=hosts[0],
                    replicas=replicas)
    rec["drain"] = fab.drain()
    rec["summary"] = fab.summary()
    rec["snapshot"] = fab.snapshot_stats()
    rec["report"] = fab.report()
    rec["ledger"] = obs.ledger.as_dict()
    rec["lead"] = [fab.prefetch_lead_steps(k, 1e-3, from_host=1)
                   for k in keys]
    rec["tiers"] = [int(fab.tier_of(k)) for k in keys]
    rec["holders"] = [fab.holders(k) for k in keys]
    return rec


@pytest.mark.parametrize("replicas", [1, 2])
@pytest.mark.parametrize("topology", [False, True],
                         ids=["uniform", "topology"])
def test_schedule_matches_reference(replicas, topology):
    ref, port = _both(_schedule, replicas, topology)
    assert port == ref
    assert port["summary"]["remote_fetches"] > 0
    if replicas == 2:
        assert all(len(h) == 2 for h in port["holders"])
    assert port["summary"]["nic_bytes"] > 0
    assert port["ledger"]["total"] > 0


def test_incast_split_matches_reference():
    def run(ns):
        obs = ns.Observability()
        clock = ns.VirtualClock()
        topo = ns.FabricTopology(hosts_per_rack=2, incast_degree=2)
        fab = ns.ShardedTieredStore(
            4, clock=clock, obs=obs, policy_factory=_pinned(ns, 1e9),
            net_model=ns.NetQueueModel(topology=topo))
        blob = np.zeros(1 << 18, np.float32)
        keys = [("kv", f"t/{i:03d}") for i in range(12)]
        for k in keys:
            fab.put(k, blob, from_host=fab.owner(k))
        clock.advance(1.0)
        pfs = [fab.get_async(k, from_host=0) for k in keys
               if fab.owner(k) != 0]
        fracs = [pf.nic_tr.incast_frac for pf in pfs]
        for pf in sorted(pfs, key=lambda p: -p.nic_tr.incast_frac):
            pf.wait()
        return fracs, obs.ledger.as_dict(), clock.now()
    ref, port = _both(run)
    assert port == ref
    assert max(port[0]) > 0 and port[1]["incast"] > 0


# ---------------------------------------------------------------------------
# elasticity and failure
# ---------------------------------------------------------------------------

def _churn(ns, rate):
    clock = ns.VirtualClock()
    obs = ns.Observability()
    fab = ns.ShardedTieredStore(3, clock=clock, obs=obs,
                                policy_factory=_pinned(ns, 1.0),
                                rebalance_rate=rate, write_shield_depth=2)
    lost = []
    fab.on_key_loss = lost.extend
    rng = np.random.default_rng(5)
    keys = _keys(40, 5)
    for i, k in enumerate(keys):
        fab.put(k, np.zeros(int(rng.integers(1, 16)) << 10, np.float32),
                tier=ns.Tier.FLASH if i % 3 else ns.Tier.DRAM,
                from_host=i % 3, replicas=1 + i % 2)
    clock.advance(0.5)
    out = {}
    out["join"] = fab.add_host(weight=1.5).as_dict()
    # a restore issued mid-rebalance pays the in-flight leg
    pfs = [fab.get_async(k, from_host=0) for k in keys[:8]]
    out["mid"] = []
    for pf in pfs:
        pf.wait()
        out["mid"].append(clock.now())
    clock.advance(0.2)
    out["leave"] = fab.remove_host(2).as_dict()
    clock.advance(0.2)
    rep = fab.fail_host(1)
    out["fail"] = rep.as_dict()
    out["lost_keys"] = list(rep.lost_keys)
    out["notified"] = list(lost)
    out["under"] = fab.under_replicated()
    out["reads"] = []
    for k in keys:
        if fab.holders(k):
            t0 = clock.now()
            fab.get(k, from_host=0)
            out["reads"].append(clock.now() - t0)
    out["drain"] = fab.drain()
    out["summary"] = fab.summary()
    out["snapshot"] = fab.snapshot_stats()
    out["rebalances"] = [rb.as_dict() for rb in fab.rebalances]
    out["moved_fraction"] = [rb.moved_fraction for rb in fab.rebalances]
    out["ledger"] = obs.ledger.as_dict()
    out["resident"] = fab.resident_bytes()
    return out


@pytest.mark.parametrize("rate", [None, 2e8], ids=["unpaced", "paced"])
def test_rebalance_and_failure_reports_match_reference(rate):
    ref, port = _both(_churn, rate)
    assert port == ref
    assert port["join"]["keys_moved"] > 0
    assert port["leave"]["action"] == "leave"
    assert port["fail"]["keys_resident"] > 0
    assert port["notified"] == port["lost_keys"]


def test_degraded_read_after_owner_failure_matches_reference():
    def run(ns):
        clock = ns.VirtualClock()
        fab = ns.ShardedTieredStore(3, clock=clock,
                                    policy_factory=_pinned(ns))
        key = ("kv", "d")
        owner = fab.owner(key)
        fab.put(key, np.zeros(1 << 16, np.float32), tier=ns.Tier.FLASH,
                from_host=owner, replicas=2)
        dst = next(h for h in range(3) if h not in fab.holders(key))
        rf = fab.get_async(key, from_host=dst)
        fab.fail_host(owner)              # the sender dies mid-flight
        assert not rf.done()
        rf.wait()
        return clock.now(), fab.summary(), fab.under_replicated()
    ref, port = _both(run)
    assert port == ref


def test_remove_and_fail_guards():
    for ns in SIDES:
        fab = ns.ShardedTieredStore(1, policy_factory=_pinned(ns))
        with pytest.raises(ValueError, match="last host"):
            fab.remove_host(0)
        with pytest.raises(ValueError, match="last host"):
            fab.fail_host(0)
        with pytest.raises(KeyError):
            fab.fail_host(7)
        with pytest.raises(KeyError):
            fab.get(("kv", "missing"))


@pytest.mark.parametrize("kw, match", [
    (dict(n_hosts=0), "at least one host"),
    (dict(n_hosts=2, weights=[1.0]), "1 ring weights for 2 hosts"),
    (dict(n_hosts=2, weights=[1.0, 0.0]), "must be positive"),
    (dict(n_hosts=2, rebalance_rate=0.0), "positive bytes/s"),
])
def test_constructor_errors_match_reference(kw, match):
    for ns in SIDES:
        with pytest.raises(ValueError, match=match):
            ns.ShardedTieredStore(**kw)
    with pytest.raises(ValueError, match="net_model"):
        PORT.ShardedTieredStore(
            2, net_model=PORT.NetQueueModel(),
            topology=PORT.FabricTopology())


def test_pool_is_not_ported():
    """The refusal this test held is lifted: the fabric takes the pool
    (runtime/pool.py) as the reference's does, one lane a host, spilling
    through the fabric's hook. tests/test_torch_fourth_tier.py holds the
    pool's records to the reference's."""
    got = []
    for ns in SIDES:
        pool = ns.PooledStore(1 << 20, clock=ns.VirtualClock())
        fab = ns.ShardedTieredStore(2, pool=pool, clock=pool.clock,
                                    policy_factory=_pinned(ns))
        assert fab.pool is pool and pool.on_evict == fab._pool_evict
        fab.add_host()
        got.append((sorted(pool.lanes), fab.summary()["pool_puts"],
                    fab.snapshot_stats()["pool"]))
    assert got[0] == got[1]
    assert got[1][0] == [0, 1, 2]


# ---------------------------------------------------------------------------
# readability gating and the runtime's gated submits
# ---------------------------------------------------------------------------

def _ingest(ns, shield):
    clock = ns.VirtualClock()
    obs = ns.Observability(trace=True)
    store = ns.TieredStore(ns.TieringPolicy(tau_hot=1e-12, tau_be=1e9),
                           clock=clock, obs=obs,
                           write_shield_depth=1 if shield else None)
    store.put("burst", np.zeros(1 << 18, np.float32), tier=ns.Tier.FLASH)
    clock.advance(1.0)
    burst = store.get_async("burst") if shield else None
    arrive = clock.now() + 0.25           # the NIC delivery time
    store.ingest("k", np.zeros(1 << 14, np.float32), tier=ns.Tier.FLASH,
                 not_before=arrive)
    pf = store.get_async("k")
    value, tr = store.read_for_transfer("k", not_before=clock.now() + 0.1)
    t0 = clock.now()
    pf.wait()
    if burst is not None:
        burst.wait()
    out = {"fetch": (pf.transfer.start_t, pf.transfer.done_t,
                     pf.transfer.gate_t),
           "read": (tr.start_t, tr.done_t, tr.kind), "stall": clock.now()
           - t0, "arrive": arrive, "flushed": store.flush_deferred_writes(),
           "stats": {t.name: dataclasses.asdict(s)
                     for t, s in store.stats.items()},
           "ledger": obs.ledger.as_dict(),
           "trace": obs.tracer.to_chrome_json()}
    # once the bytes arrived, a read is no longer gated
    out["after"] = store.get_async("k").transfer.gate_t
    return out


@pytest.mark.parametrize("shield", [False, True])
def test_readability_gating_matches_reference(shield):
    ref, port = _both(_ingest, shield)
    assert port == ref
    start, done, gate = port["fetch"]
    assert gate == port["arrive"] and start >= port["arrive"]
    assert port["ledger"]["interference"] > 0
    assert port["after"] is None
    if shield:
        assert port["stats"]["FLASH"]["rebalance_deferred"] == 1
        assert "rebalance_write_deferred" in port["trace"]


def test_runtime_gated_submit_ctx_and_add_lane_match_reference():
    def run(ns):
        clock = ns.VirtualClock()
        rt = ns.AsyncTierRuntime(clock=clock)
        topo = ns.FabricTopology(hosts_per_rack=2)
        rt.add_lane("NIC", ns.NetQueueModel(topology=topo))
        with pytest.raises(ValueError, match="already registered"):
            rt.add_lane("NIC", ns.NetQueueModel())
        trs = [rt.submit("NIC", i, 1 << 20, not_before=0.01 * i,
                         ctx={"src": 0, "dst": d, "fan_in": f})
               for i, (d, f) in enumerate([(1, 1), (2, 1), (3, 4)])]
        trs.append(rt.submit(ns.Tier.DRAM, "x", 1 << 20, kind="rebalance"))
        trs.append(rt.submit(ns.Tier.DRAM, "y", 1 << 20))
        stalls = [rt.wait(t) for t in trs[::-1]]
        return ([(t.start_t, t.done_t, t.gate_t, t.behind_interference)
                 for t in trs], stalls, rt.snapshot_stats(), rt.report(),
                rt.ledger.as_dict())
    ref, port = _both(run)
    assert port == ref
    assert port[0][4][3] is True           # queued behind the rebalance


@pytest.mark.parametrize("src, dst, fan_in", [(0, 1, 1), (0, 2, 1),
                                              (3, 0, 5), (None, None, 3)])
@pytest.mark.parametrize("depth", [1, 3, 9])
def test_net_queue_model_matches_reference(src, dst, fan_in, depth):
    for topo in (False, True):
        got, want = (ns.NetQueueModel(
            rtt=30e-6, sat_depth=4,
            topology=ns.FabricTopology(hosts_per_rack=2)
            if topo else None).service(3 << 20, depth, src=src, dst=dst,
                                       fan_in=fan_in)
            for ns in (PORT, REF))
        assert (got.occupancy, got.latency) == (want.occupancy,
                                                want.latency)


def test_topology_validation_matches_reference():
    for ns in SIDES:
        with pytest.raises(ValueError, match="invalid topology"):
            ns.FabricTopology(spine_rtt=1e-6)
        with pytest.raises(ValueError, match="invalid NIC"):
            ns.NetQueueModel(bandwidth=0.0)
        topo = ns.FabricTopology(hosts_per_rack=3, incast_degree=2)
        assert [topo.rack_of(h) for h in range(7)] == [0, 0, 0, 1, 1, 1, 2]
        assert topo.incast_factor(5) == 2.5


@pytest.mark.parametrize("write_bw", [None, 3e9])
def test_tier_spec_write_bw_matches_reference(write_bw):
    got = PORT.TierSpec(1e9, 7e9, 2e-5, write_bw=write_bw)
    want = REF.TierSpec(1e9, 7e9, 2e-5, write_bw=write_bw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.effective_write_bw == want.effective_write_bw
    assert got.effective_write_bw == (7e9 if write_bw is None else 3e9)


def test_host_view_ducktypes_the_store_like_the_reference():
    def run(ns):
        clock = ns.VirtualClock()
        fab = ns.ShardedTieredStore(3, clock=clock,
                                    policy_factory=_pinned(ns, 1.0))
        view = fab.host_view(1, replicas=2)
        view.put(("kv", "a"), np.zeros(1 << 12, np.float32))
        view.move(("kv", "a"), ns.Tier.FLASH)
        clock.advance(0.3)
        v = view.get(("kv", "a"))
        out = (view.label, view.host, int(view.tier_of(("kv", "a"))),
               view.estimate_fetch_seconds(("kv", "a")),
               view.prefetch_lead_steps(("kv", "a"), 1e-4), v.nbytes,
               fab.holders(("kv", "a")), clock.now(),
               view.runtime.snapshot_stats(),
               {t.name: dataclasses.asdict(s)
                for t, s in view.stats.items()})
        view.delete(("kv", "a"))
        return out + (view.tier_of(("kv", "a")),)
    ref, port = _both(run)
    assert port == ref
