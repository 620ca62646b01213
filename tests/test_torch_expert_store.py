"""The port's MoE expert store (`repro_torch.tiering.expert_store`,
`Platform.expert_store`) against the JAX reference's.

The store is the same modeled Python on both sides, over the same
runtime, so every record must match: the scenarios of the reference's
tests (tests/test_substrates.py, test_fabric.py, test_fabric_elastic.py,
test_async_runtime.py, test_autopilot.py and test_platform.py) run on
both packages, their asserts on each, and `_both` holds the records
equal: virtual-clock stalls to 1e-12 relative, counts, tiers and hosts
exactly. The port's economic gates keep their reuse sketch on the CPU."""
import functools
import math
import types
import warnings

import numpy as np
import pytest

import repro.autopilot as j_autopilot
import repro.core.policy as j_policy
import repro.platform as j_platform
import repro.runtime as j_rt
import repro.tiering as j_tiering
import repro_torch.autopilot as t_autopilot
import repro_torch.core.policy as t_policy
import repro_torch.platform as t_platform
import repro_torch.runtime as t_rt
import repro_torch.tiering as t_tiering

REL = 1e-12


def _ns(policy, autopilot, rt, tiering, platform, **kw):
    return types.SimpleNamespace(
        Tier=policy.Tier, TieringPolicy=policy.TieringPolicy,
        VirtualClock=rt.VirtualClock,
        ShardedTieredStore=rt.ShardedTieredStore,
        ExpertStore=tiering.ExpertStore, P=platform,
        EconomicGate=functools.partial(autopilot.EconomicGate, **kw),
        compile=functools.partial(platform.Platform.compile, **kw))


REF = _ns(j_policy, j_autopilot, j_rt, j_tiering, j_platform)
PORT = _ns(t_policy, t_autopilot, t_rt, t_tiering, t_platform, device="cpu")


def _close(got, want, path="$"):
    """Equal trees; floats to REL relative."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        for k in want:
            _close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        assert math.isclose(got, want, rel_tol=REL, abs_tol=0.0), \
            (path, got, want)
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


def _both(fn):
    """fn on the reference and the port; the records must be equal. The
    port's is returned."""
    want, got = fn(REF), fn(PORT)
    _close(got, want)
    return got


def _pinned(ns):
    # thresholds pinned so objects stay where the test puts them
    return ns.TieringPolicy(tau_hot=1e-12, tau_be=1e-9, ema_alpha=1.0)


def _fabric(ns, n_hosts):
    return ns.ShardedTieredStore(n_hosts,
                                 policy_factory=lambda _h=0: _pinned(ns),
                                 clock=ns.VirtualClock())


def _plan(plan):
    return {k: (v.tolist() if isinstance(v, np.ndarray) else v)
            for k, v in plan.items()}


def test_residency_plan():
    """tests/test_substrates.py::test_expert_store_residency_plan."""
    def scenario(ns):
        pol = ns.TieringPolicy(tau_hot=0.05, tau_be=5.0)
        es = ns.ExpertStore(n_layers=2, n_experts=8, policy=pol,
                            expert_bytes=1024.0)
        rng = np.random.default_rng(0)
        # expert 0 is hot (picked every step), expert 7 never picked
        for step in range(50):
            ids = np.concatenate([np.zeros(64, np.int64),
                                  rng.integers(1, 7, 16)])
            es.observe_step({0: ids, 1: ids}, now=step * 0.01, tokens=80)
        plan = es.residency_plan(step_time=0.01)
        tiers = plan["tiers"]
        assert tiers[0, 0] == ns.Tier.HBM         # always-selected expert
        assert tiers[0, 7] == ns.Tier.FLASH       # never-selected expert
        assert plan["hbm_experts"] >= 2
        assert plan["flash_experts"] >= 2
        return {"plan": _plan(plan), "counts": es.counts.tolist(),
                "tau": es.reuse_intervals(0.01).tolist(),
                "steps": es.steps, "tokens": es.tokens_per_step}
    got = _both(scenario)
    assert got["plan"]["hbm_bytes"] == 1024.0 * got["plan"]["hbm_experts"]


def test_shards_replicated_cold_experts():
    """tests/test_fabric.py::test_expert_store_shards_replicated_cold_
    experts."""
    def scenario(ns):
        fab = _fabric(ns, 4)
        es = ns.ExpertStore(n_layers=1, n_experts=8, policy=_pinned(ns),
                            store=fab.host_view(0, replicas=2))
        w = np.arange(32 * 32, dtype=np.float32).reshape(32, 32)
        for e in range(8):
            es.store.put((0, e), w, tier=ns.Tier.FLASH)
        fab.drain()
        holders = [fab.holders((0, e)) for e in range(8)]
        for e in range(8):
            assert holders[e] == fab.ring_hosts((0, e))[:2]
        started = es.prefetch_experts(0, list(range(8)))
        assert started == 8
        fab.hosts[0].runtime.advance(1.0)
        t0 = es.clock.now()
        for e in range(8):
            np.testing.assert_array_equal(es.fetch_expert(0, e), w)
        assert es.clock.now() == t0            # all overlapped
        expect_local = sum(0 in fab.ring_hosts((0, e))[:2]
                           for e in range(8))
        assert fab.local_fetches == expect_local
        assert fab.remote_fetches == 8 - expect_local
        return {"holders": [list(h) for h in holders], "started": started,
                "now": es.clock.now(), "local": fab.local_fetches,
                "remote": fab.remote_fetches}
    _both(scenario)


def test_locality_host():
    """tests/test_fabric_elastic.py::test_expert_store_locality_host."""
    def scenario(ns):
        fab = _fabric(ns, 3)
        es = ns.ExpertStore(n_layers=1, n_experts=4, policy=_pinned(ns),
                            store=fab.host_view(0))
        es.store.put((0, 0), np.zeros(128, np.float32), tier=ns.Tier.FLASH)
        fab.drain()
        assert es.locality_host(0, 0) == fab.owner((0, 0))
        assert es.locality_host(0, 3) == 0         # absent -> own host
        lead = es.prefetch_lead_steps(0, 0, 2e-3)
        assert lead >= 1
        return {"hosts": [es.locality_host(0, e) for e in range(4)],
                "owner": fab.owner((0, 0)), "lead": lead,
                "now": es.clock.now()}
    _both(scenario)


def test_prefetch_streams_behind_compute():
    """tests/test_async_runtime.py::test_expert_prefetch_streams_behind_
    compute."""
    def scenario(ns):
        pol = ns.TieringPolicy(tau_hot=1e-12, tau_be=1e-9, ema_alpha=1.0)
        es = ns.ExpertStore(n_layers=1, n_experts=4, policy=pol)
        w = np.ones((64, 64), np.float32)
        for e in range(4):
            es.store.put((0, e), w, tier=ns.Tier.FLASH)
        started = [es.prefetch_experts(0, [1, 2]), es.prefetch_experts(0, [1])]
        assert started == [2, 0]                   # idempotent
        es.store.runtime.advance(1.0)              # a layer of compute
        t0 = es.clock.now()
        out = es.fetch_expert(0, 1)
        assert es.clock.now() == t0                # overlapped: no stall
        np.testing.assert_array_equal(out, w)
        t1 = es.clock.now()
        es.fetch_expert(0, 3)                      # never prefetched
        return {"started": started, "t0": t0, "cold_stall": es.clock.now()
                - t1, "tier": int(es.store.tier_of((0, 3)))}
    got = _both(scenario)
    assert got["cold_stall"] > 0


def test_decode_step_pipelines_prefetch():
    """tests/test_autopilot.py::test_expert_decode_step_pipelines_prefetch:
    the pipelined decode step stalls less than the unpipelined fetch loop,
    and the gate's expert class has the reference's measured mass."""
    def run(ns, pipelined):
        clock = ns.VirtualClock()
        gate = ns.EconomicGate(tau_hot=1e-4, tau_be=0.5)
        es = ns.ExpertStore(n_layers=4, n_experts=8, policy=gate,
                            clock=clock)
        for layer in range(4):
            for e in range(8):
                es.store.put((layer, e), np.zeros(1 << 16, np.float32),
                             tier=ns.Tier.FLASH)
        es.store.runtime.drain()
        es.store.reset_stats()
        rng = np.random.default_rng(0)
        stall, steps = 0.0, []
        for _ in range(12):
            routings = {l: rng.integers(0, 8, 2) for l in range(4)}
            if pipelined:
                rec = es.decode_step(routings, layer_time=2e-3)
                steps.append(rec)
                stall += rec["stall"]
            else:
                for l in sorted(routings):
                    for e in np.unique(routings[l]):
                        t0 = clock.now()
                        es.fetch_expert(l, int(e))
                        stall += clock.now() - t0
                    es.store.runtime.advance(2e-3)
        return stall, es, steps

    def scenario(ns):
        stall_pipe, es, steps = run(ns, True)
        stall_sync, _, _ = run(ns, False)
        assert stall_pipe < stall_sync
        mass = es.policy.tracker.class_mass("expert")
        assert mass > 0
        return {"pipe": stall_pipe, "sync": stall_sync, "steps": steps,
                "mass": float(mass), "now": es.clock.now(),
                "tiers": [[int(es.store.tier_of((l, e))) for e in range(8)]
                          for l in range(4)],
                "counts": es.counts.tolist(),
                "plan": _plan(es.residency_plan(2e-3 * 4))}
    _both(scenario)


def test_platform_expert_store_is_warning_free():
    """tests/test_platform.py::test_platform_expert_store_and_engine_are_
    warning_free (its expert-store half)."""
    def scenario(ns):
        spec = ns.P.HierarchySpec(hosts=(ns.P.HostDecl(count=2),),
                                  policy=ns.P.PolicyDecl.pinned_flash())
        p = ns.compile(spec)
        with warnings.catch_warnings():
            warnings.simplefilter("error", DeprecationWarning)
            es = p.expert_store(n_layers=1, n_experts=4, host=1, replicas=2)
        assert es.host == 1                 # host identity from the view
        assert es.store.replicas == 2
        es.store.put((0, 0), np.zeros(256, np.float32), tier=ns.Tier.FLASH)
        p.drain()
        holders = list(p.fabric.holders((0, 0)))
        assert len(holders) == 2
        return {"host": es.host, "replicas": es.store.replicas,
                "holders": holders, "now": p.clock.now()}
    _both(scenario)


def test_deprecated_dialect_warns_but_works():
    """tests/test_platform.py::test_legacy_fabric_dialects_warn_but_work
    (its ExpertStore part): the old fabric=/host=/replicas= constructor
    warns and builds the host view it names."""
    def scenario(ns):
        fab = ns.ShardedTieredStore(2,
                                    policy_factory=lambda _h=0: _pinned(ns),
                                    clock=ns.VirtualClock())
        with pytest.warns(DeprecationWarning, match="ExpertStore") as rec:
            es = ns.ExpertStore(n_layers=1, n_experts=2, policy=_pinned(ns),
                                fabric=fab, host=1, replicas=2)
        assert es.host == 1
        es.store.put((0, 0), np.zeros(64, np.float32), tier=ns.Tier.FLASH)
        fab.drain()
        assert len(fab.holders((0, 0))) == 2
        return {"host": es.host, "holders": list(fab.holders((0, 0))),
                "warned": len(rec)}
    _both(scenario)
