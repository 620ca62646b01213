"""The PyTorch port's observability plane (tracer, metrics registry,
`Observability`) against the JAX reference's.

The plane is the same Python on both sides and reads only the modeled
virtual clock, so its exports must be byte-identical: the same calls give
the same Perfetto JSON and flamegraph, the same schedule gives the same
`MetricsRegistry.snapshot()` (before and after `reset()`), and the
quickstart's traced session and an admission-benchmark cell export the
same trace bytes. The stall ledger conserves: its components sum to its
total to 1e-12 relative."""
import json

import numpy as np
import pytest

import repro.autopilot.bench as j_bench
import repro.obs as j_obs
import repro.platform as j_plat
import repro_torch.autopilot.bench as t_bench
import repro_torch.obs as t_obs
import repro_torch.platform as t_plat
from repro_torch.core.policy import Tier, TieringPolicy
from repro_torch.runtime import TieredStore, VirtualClock

REL = 1e-12


def _conserves(ledger: dict) -> bool:
    parts = sum(v for k, v in ledger.items()
                if k not in ("total", "tenants"))
    return abs(parts - ledger["total"]) <= REL * max(abs(ledger["total"]),
                                                     1e-30)


# ---------------------------------------------------------------------------
# Tracer
# ---------------------------------------------------------------------------

def _trace_calls(obs_mod, max_events, seed):
    rng = np.random.default_rng(seed)
    t = obs_mod.Tracer(max_events=max_events)
    tracks = [t.track(f"host{h}", lane) for h in range(3)
              for lane in ("FLASH", "DRAM", "NIC")]
    for i in range(40):
        tr = tracks[int(rng.integers(len(tracks)))]
        ts, dur = float(rng.uniform(0, 2)), float(rng.uniform(-1e-4, 1e-2))
        kind = int(rng.integers(4))
        if kind == 0:
            t.complete(tr, "fetch", ts, dur, cat="transfer",
                       args={"key": f"k{i}", "nbytes": int(i) << 10,
                             "depth": np.int64(i % 5)})
        elif kind == 1:
            t.instant(tr, "admit_tier", ts, cat="policy",
                      args={"est": float("inf") if i % 7 == 0 else ts})
        elif kind == 2:
            t.instant(tr, "plain", ts)
        else:
            key = ("session", f"s{i % 4}")
            getattr(t, ("flow_start", "flow_step", "flow_end")[i % 3])(
                tr, f"session:s{i % 4}", ts, key)
    return t.to_chrome_json(), t.flamegraph(), len(t), t.dropped


@pytest.mark.parametrize("max_events", [200_000, 25])
@pytest.mark.parametrize("seed", [0, 1])
def test_tracer_export_matches_reference(max_events, seed):
    got = _trace_calls(t_obs, max_events, seed)
    want = _trace_calls(j_obs, max_events, seed)
    assert got == want
    if max_events == 25:
        assert got[3] > 0
    doc = json.loads(got[0])
    assert doc["otherData"]["dropped_events"] == got[3]


def test_tracer_flow_ids_and_tracks_are_first_seen_order():
    t = t_obs.Tracer()
    assert t.track("b") == (1, 1) and t.track("a", "x") == (2, 1)
    assert t.track("b", "y") == (1, 2) and t.track("b") == (1, 1)
    assert [t.flow_id(k) for k in ("q", "p", "q")] == [1, 2, 1]


# ---------------------------------------------------------------------------
# MetricsRegistry
# ---------------------------------------------------------------------------

def _metrics_schedule(obs_mod, seed):
    rng = np.random.default_rng(seed)
    reg = obs_mod.MetricsRegistry()
    led = obs_mod.StallLedger()
    reg.register("stall_ledger", led)
    snaps = []
    for step in range(3):
        for _ in range(30):
            h = f"host{int(rng.integers(12))}"
            reg.counter("transfers").inc((h, "FLASH", "fetch"))
            reg.counter("bytes_moved").inc((h,), float(rng.integers(1 << 20)))
            reg.gauge("depth").set((h,), float(rng.integers(9)))
            reg.gauge("occupancy").inc((h,), 0.5)
            led.add(("flash_service", "nic_queue", "other")[
                int(rng.integers(3))], float(rng.uniform(0, 1e-3)),
                f"t{int(rng.integers(3))}")
        reg.histogram("stall_seconds").observe_batch(
            rng.lognormal(-7, 2, 200), ("host0", "FLASH"))
        reg.histogram("stall_seconds").observe(0.0, ("host1", "NIC"))
        reg.histogram("gap", n_buckets=8, tau0=1e-2).observe_batch(
            np.zeros(0))
        reg.counter("anon").inc()
        snaps.append(reg.snapshot())
        if step == 1:
            reg.reset()
            snaps.append(reg.snapshot())
    hist = reg.histogram("stall_seconds")
    snaps.append([hist.quantile(q, ("host0", "FLASH"))
                  for q in (0.01, 0.5, 0.99)]
                 + [hist.quantile(0.5, ("none",)),
                    hist.count(("host0", "FLASH")),
                    reg.counter("transfers").labels()[:3],
                    reg.components()])
    return snaps


@pytest.mark.parametrize("seed", [0, 7])
def test_metrics_snapshot_matches_reference_across_reset(seed):
    got = _metrics_schedule(t_obs, seed)
    want = _metrics_schedule(j_obs, seed)
    assert got == want
    after_reset = got[2]
    assert all(v == 0.0 for v in
               after_reset["counters"]["transfers"].values())
    assert after_reset["components"]["stall_ledger"]["total"] == 0.0


def test_registry_protocol_errors_match_reference():
    class Bad:
        def snapshot_stats(self):
            return {}

    for mod in (t_obs, j_obs):
        reg = mod.MetricsRegistry()
        with pytest.raises(TypeError, match="lacks reset_stats"):
            reg.register("bad", Bad())
        assert reg.components() == []


@pytest.mark.parametrize("metrics", [True, False])
def test_observability_snapshot_and_reset_match_reference(metrics):
    def run(mod):
        obs = mod.Observability(trace=True, metrics=metrics, max_events=9)
        obs.ledger.add("flash_service", 2e-3, "t0")
        if obs.metrics is not None:
            obs.metrics.counter("n").inc(("h",), 3.0)
        snaps = [obs.snapshot_stats()]
        obs.reset_stats()
        snaps.append(obs.snapshot_stats())
        return snaps, obs.tracer.max_events
    assert run(t_obs) == run(j_obs)


# ---------------------------------------------------------------------------
# traces of whole flows: quickstart §6, the admission bench, the store
# ---------------------------------------------------------------------------

def _quickstart_trace(plat, **compile_kw):
    spec = plat.HierarchySpec(
        hosts=(plat.HostDecl(tiers={"dram": plat.TierDecl(256e9, 45e9,
                                                           5e-7)}),
               plat.HostDecl(count=3)),
        policy=plat.PolicyDecl.economic(l_blk=128 << 10),
        class_priors={"kv": 2.0},
        observability=plat.ObservabilityDecl(trace=True))
    traced = plat.Platform.compile(spec, **compile_kw)
    sess = traced.kv_session("user-42")
    sess.save(np.zeros(1 << 16, np.float32))
    traced.clock.advance(5.0)
    sess.resume()
    return (traced.tracer.to_chrome_json(), traced.tracer.flamegraph(),
            traced.ledger.as_dict(), traced.snapshot_stats())


def test_quickstart_trace_is_byte_identical_to_reference():
    got = _quickstart_trace(t_plat, device="cpu")
    want = _quickstart_trace(j_plat)
    assert got[0] == want[0]
    assert got[1:] == want[1:]
    assert _conserves(got[2]) and got[2]["total"] > 0
    names = {e["name"] for e in json.loads(got[0])["traceEvents"]}
    assert {"admit_tier", "stall", "fetch", "write"} <= names


@pytest.mark.parametrize("scenario, mode", [("zipf", "economic"),
                                            ("scan_flood", "dram")])
def test_admission_bench_trace_matches_reference(scenario, mode):
    kw = dict(n_steps=40, seed=1)
    t_o, j_o = t_obs.Observability(trace=True), j_obs.Observability(
        trace=True)
    got = t_bench.run_scenario(scenario, mode, obs=t_o, device="cpu", **kw)
    want = j_bench.run_scenario(scenario, mode, obs=j_o, **kw)
    plain = t_bench.run_scenario(scenario, mode, device="cpu", **kw)
    assert t_obs.bench_json(got) == j_obs.bench_json(want)
    # observing never perturbs the modeled record
    assert t_obs.bench_json(got) == t_obs.bench_json(plain)
    assert t_o.tracer.to_chrome_json() == j_o.tracer.to_chrome_json()
    assert t_o.metrics.snapshot() == j_o.metrics.snapshot()
    assert t_o.ledger.as_dict() == j_o.ledger.as_dict()
    assert _conserves(t_o.ledger.as_dict())
    if mode == "economic":
        assert "admit_tier" in t_o.tracer.to_chrome_json()


def test_write_shield_deferral_instants_match_reference():
    from repro.core.policy import Tier as JTier, TieringPolicy as JPolicy
    from repro.runtime import TieredStore as JStore, VirtualClock as JClock

    def run(obs_mod, Store, Policy, T, Clock):
        obs = obs_mod.Observability(trace=True)
        clock = Clock()
        store = Store(Policy(tau_hot=1e-12, tau_be=1e9), clock=clock,
                      obs=obs, write_shield_depth=1, specs=None)
        store.put("r", np.zeros(1 << 18, np.float32), tier=T.FLASH)
        for i in range(40):
            store.put(("d", i), np.zeros(1 << 16, np.float32), tier=T.DRAM)
        clock.advance(1.0)
        pf = store.get_async("r")
        store.move(("d", 0), T.FLASH)       # demotion under the burst
        pf.wait()
        store.flush_deferred_writes()
        return (obs.tracer.to_chrome_json(), obs.metrics.snapshot(),
                obs.ledger.as_dict())
    got = run(t_obs, TieredStore, TieringPolicy, Tier, VirtualClock)
    want = run(j_obs, JStore, JPolicy, JTier, JClock)
    assert got == want
    assert "demotion_write_deferred" in got[0]
