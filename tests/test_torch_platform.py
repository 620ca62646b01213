"""The PyTorch port's declared platform against the JAX reference's:
`HierarchySpec` -> `Platform.compile` -> fabric -> `DecodeEngine`, the
example and benchmark twins, and cross-host resume.

What must match, and how closely:
  * spec JSON, Perfetto exports, bench JSON, report strings: byte for
    byte (the same modeled Python on both sides);
  * modeled float64 scalars (stalls, clocks, advice fields): 1e-12
    relative;
  * generated tokens at reduced gemma-2b in float32 (the JAX side with
    `init_params` weights, the port with the same weights through
    `params_from_jax`, on `device="cpu"`): equal, as in
    `test_torch_serving.py`, whose logit tolerances hold underneath.

Inputs are made from numpy seeds."""
import contextlib
import dataclasses
import io
import json
import math
import pathlib
import runpy
import sys

import jax
import numpy as np
import pytest
import torch

import repro.platform as JP
import repro.serving.bench as j_sbench
from repro.configs import get_config as j_get_config
from repro.core.policy import TieringPolicy as JPolicy
from repro.models import model as JM
from repro.parallel.sharding import single_device_rules
from repro.runtime import ShardedTieredStore as JFabric
from repro.runtime import VirtualClock as JClock
from repro.serving.engine import DecodeEngine as JEngine
from repro.serving.engine import Request as JReq
from repro.serving.engine import route_session as j_route
import repro_torch.platform as TP
import repro_torch.serving.bench as t_sbench
from repro_torch.configs import get_config
from repro_torch.core.policy import Tier as TTier
from repro_torch.core.policy import TieringPolicy as TPolicy
from repro_torch.models import model as TM
from repro_torch.runtime import ShardedTieredStore as TFabric
from repro_torch.runtime import VirtualClock as TClock
from repro_torch.serving import DecodeEngine as TEngine
from repro_torch.serving import Request as TReq
from repro_torch.serving import route_session as t_route

ROOT = pathlib.Path(__file__).resolve().parents[1]
REL = 1e-12


def _close(got, want, path="$"):
    """Equal trees; floats to 1e-12 relative."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        for k in want:
            _close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        assert math.isclose(got, want, rel_tol=REL, abs_tol=0.0) or (
            math.isnan(got) and math.isnan(want)), (path, got, want)
    else:
        assert got == want, (path, got, want)


# ---------------------------------------------------------------------------
# HierarchySpec: JSON bytes, round trips, validation errors
# ---------------------------------------------------------------------------

def _specs(P):
    """The five named declarations, built from either package."""
    return {
        "one_host_static": P.HierarchySpec(
            hosts=(P.HostDecl(),),
            policy=P.PolicyDecl.static(tau_hot=0.05, tau_be=1.0,
                                       ema_alpha=1.0),
            step_time=5e-3),
        "quickstart_economic": P.HierarchySpec(
            hosts=(P.HostDecl(tiers={"dram": P.TierDecl(256e9, 45e9,
                                                        5e-7)}),
                   P.HostDecl(count=3)),
            policy=P.PolicyDecl.economic(l_blk=128 << 10),
            class_priors={"kv": 2.0}),
        "topology_net": P.HierarchySpec(
            hosts=(P.HostDecl(tiers={
                "dram": P.TierDecl(256e9, 45e9, 5e-7),
                "flash": P.TierDecl(8e12, 7e9, 2e-5, write_bw=3e9)}),
                P.HostDecl(count=3, weight=0.5)),
            policy=P.PolicyDecl.economic(l_blk=64 << 10, alpha_stall=2.0),
            topology=P.TopologyDecl(hosts_per_rack=2),
            net=P.NetDecl(rtt=30e-6),
            class_priors={"kv": 2.0, "expert": 0.5},
            replicas=2, vnodes=96, write_shield_depth=3,
            rebalance_rate=2e9, step_time=1e-3, mttf=3600.0,
            checkpoint_interval=0.5,
            autoscale=P.AutoscaleDecl(max_hosts=6, active_window=4.0),
            scheduler=P.SchedulerDecl(pause_idle_steps=2,
                                      prefetch_lead=3),
            observability=P.ObservabilityDecl(trace=True,
                                              max_events=1000)),
        "pool": P.HierarchySpec(
            hosts=(P.HostDecl(count=2, tiers={
                "gpu_flash": P.gpu_flash_tier(write_bw=2e9)}),),
            pool=P.PoolDecl(capacity_bytes=64e9, write_bw=20e9),
            policy=P.PolicyDecl.economic(nand="tlc")),
        "workload": P.HierarchySpec(
            hosts=(P.HostDecl(count=2),),
            workload=P.WorkloadDecl(tenants=[
                P.TenantDecl("chat", n_sessions=6,
                             session=P.SessionShapeDecl.chat(),
                             arrival=P.ArrivalDecl(kind="diurnal",
                                                   period=24),
                             slo=P.SloDecl(p99_stall_budget=1e-3,
                                           alpha_stall=1.5)),
                P.TenantDecl("rag", session=P.SessionShapeDecl.rag(),
                             arrival=P.ArrivalDecl(
                                 kind="flash_crowd", peak_step=30,
                                 background_per_step=2,
                                 background_pool=64)),
                P.TenantDecl("scan", session=P.SessionShapeDecl.scan(),
                             arrival=P.ArrivalDecl(kind="scan_flood"))],
                horizon_steps=64, seed=3, isolation="shared"),
            step_time="measured", roofline_arch="gemma-2b"),
    }


@pytest.mark.parametrize("name", list(_specs(TP)))
@pytest.mark.parametrize("indent", [None, 2])
def test_spec_json_byte_identical_to_reference(name, indent):
    got, want = _specs(TP)[name], _specs(JP)[name]
    js = got.to_json(indent=indent)
    assert js == want.to_json(indent=indent)
    # each side reads the other's bytes back to an equal declaration
    again = TP.HierarchySpec.from_json(want.to_json(indent=indent))
    assert again == got and again.to_json(indent=indent) == js
    assert JP.HierarchySpec.from_json(js) == want
    assert got.resolved_weights() == want.resolved_weights()
    assert got.resolved_step_time() == want.resolved_step_time()


def test_spec_derived_values_match_reference():
    for name, spec in _specs(TP).items():
        ref = _specs(JP)[name]
        assert spec.n_hosts == ref.n_hosts
        for h, r in zip(spec.expanded_hosts(), ref.expanded_hosts()):
            got, want = h.tier_specs(), r.tier_specs()
            assert (got is None) == (want is None)
            if got is not None:
                assert {int(t): dataclasses.asdict(s)
                        for t, s in got.items()} == {
                    int(t): dataclasses.asdict(s) for t, s in want.items()}
    wl_t = _specs(TP)["workload"].workload
    wl_j = _specs(JP)["workload"].workload
    for a, b in zip(wl_t.tenants, wl_j.tenants):
        np.testing.assert_array_equal(a.arrival.intensity(64),
                                      b.arrival.intensity(64))


def _invalid(P):
    return [
        (P.HierarchySpec(hosts=()), "at least one host"),
        (P.HierarchySpec(hosts=(P.HostDecl(
            tiers={"dram": P.TierDecl(0.0, 45e9, 5e-7)}),)),
         "capacity_bytes must be > 0"),
        (P.HierarchySpec(hosts=(P.HostDecl(
            tiers={"l2": P.TierDecl(1e9, 1e9, 1e-7)}),)), "unknown tier"),
        (P.HierarchySpec(policy=P.PolicyDecl(kind="lru")),
         "unknown policy kind"),
        (P.HierarchySpec(policy=P.PolicyDecl(kind="static")),
         "needs explicit tau_hot"),
        (P.HierarchySpec(policy=P.PolicyDecl(host_profile="tpu")),
         "unknown host_profile"),
        (P.HierarchySpec(hosts=(P.HostDecl(count=3),), weights=(1.0, 2.0)),
         "2 ring weights for 3 hosts"),
        (P.HierarchySpec(weights=(-1.0,)), "weights must be positive"),
        (P.HierarchySpec(weighting="dram"), "unknown weighting"),
        (P.HierarchySpec(clock="sundial"), "unknown clock source"),
        (P.HierarchySpec(step_time="profiled"), "seconds or 'measured'"),
        (P.HierarchySpec(class_priors={"kv": -1.0}), "positive seconds"),
        (P.HierarchySpec(replicas=0), "must be >= 1"),
        (P.HierarchySpec(write_shield_depth=0), "shield forever"),
        (P.HierarchySpec(rebalance_rate=-5.0), "positive bytes/s"),
        (P.HierarchySpec(autoscale=P.AutoscaleDecl(min_hosts=4,
                                                   max_hosts=2)),
         "max_hosts=2 < min_hosts=4"),
        (P.HierarchySpec(autoscale=P.AutoscaleDecl(template=3)),
         "out of range"),
        (P.HierarchySpec(pool=P.PoolDecl(capacity_bytes=1e9,
                                         rent_factor=1.0)), "rent_factor"),
        (P.HierarchySpec(workload=P.WorkloadDecl()), "at least one tenant"),
        (P.HierarchySpec(workload=P.WorkloadDecl(tenants=(
            P.TenantDecl("a/b"),))), "without '/'"),
        (P.HierarchySpec(topology=P.TopologyDecl(spine_rtt=1e-9)),
         "invalid topology"),
        (P.HierarchySpec(net=P.NetDecl(sat_depth=0)), "invalid NIC"),
        (P.HierarchySpec(observability=P.ObservabilityDecl(max_events=0)),
         "max_events"),
    ]


@pytest.mark.parametrize("case", range(len(_invalid(TP))))
def test_invalid_spec_errors_match_reference(case):
    got_spec, fragment = _invalid(TP)[case]
    want_spec, _ = _invalid(JP)[case]
    with pytest.raises(ValueError, match=fragment) as want:
        want_spec.validate()
    with pytest.raises(ValueError, match=fragment) as got:
        got_spec.validate()
    assert str(got.value) == str(want.value)


def test_from_json_errors_match_reference():
    bad = json.loads(TP.HierarchySpec().to_json())
    bad["version"] = 99
    for blob, fragment in (("{nope", "not valid JSON"),
                           (json.dumps({"n_hosts": 4}), "unknown fields"),
                           ("[1]", "must be an object"),
                           (json.dumps(bad), "version 99")):
        with pytest.raises(ValueError, match=fragment) as got:
            TP.HierarchySpec.from_json(blob)
        with pytest.raises(ValueError) as want:
            JP.HierarchySpec.from_json(blob)
        assert str(got.value) == str(want.value)
    spec = TP.HierarchySpec(policy=lambda h: TPolicy(tau_hot=0.1,
                                                     tau_be=1.0))
    with pytest.raises(ValueError, match="cannot be serialized"):
        spec.to_json()


# ---------------------------------------------------------------------------
# Platform: the quickstart's §5 flow, elasticity, advice, errors
# ---------------------------------------------------------------------------

def _quickstart(P, **kw):
    spec = _specs(P)["quickstart_economic"]
    platform = P.Platform.compile(spec, **kw)
    out = {"n_hosts": platform.n_hosts,
           "weights": spec.resolved_weights(),
           "tau_be": platform.policy(0).tau_be,
           "tau_hot": platform.policy(2).tau_hot}
    sess = platform.kv_session("user-42")
    first = sess.save(np.zeros(1 << 16, np.float32))
    h = sess.prefetch()
    out["states"] = [first.done(), h.done(), sess.prefetch() is h]
    platform.clock.advance(0.01)
    out["states"].append(h.done())
    out["value"] = float(h.result().sum())
    out["states"].append(h.done())
    out["tier"] = int(sess.tier())
    out["lead"] = sess.lead_steps(1e-3)
    other = platform.kv_session("user-7", host=3)
    other.save(np.ones(1 << 14, np.float32))
    out["prefer"] = [other.preferred_host(), other.route().host]
    out["other"] = float(other.fetch().result().sum())
    out["advice"] = platform.advise().as_dict()
    out["availability"] = platform.advise_availability(
        mttf=3600.0).as_dict()
    out["tiers"] = platform.advise_tiers(access_rate=5e4).as_dict()
    out["join"] = platform.add_host().as_dict()
    out["fail"] = platform.fail_host(1).as_dict()
    out["after_fail"] = platform.advise().as_dict()
    out["checkpoint_steps"] = [platform.checkpoint_steps(),
                               platform.checkpoint_steps(1e-3)]
    out["summary"] = platform.summary()
    out["report"] = platform.report()
    out["drain"] = platform.drain()
    snap = platform.snapshot_stats()
    out["snapshot"] = snap
    platform.reset_stats()
    out["reset"] = platform.snapshot_stats()
    out["now"] = platform.clock.now()
    return out


def test_quickstart_platform_flow_matches_reference():
    got = _quickstart(TP, device="cpu")
    want = _quickstart(JP)
    _close(got, want)
    assert got["states"] == [True, False, True, True, True]
    assert got["fail"]["host"] == 1.0 and got["n_hosts"] == 4


def test_platform_without_metrics_or_advisor_matches_reference():
    def run(P, **kw):
        spec = dataclasses.replace(
            _specs(P)["one_host_static"],
            observability=P.ObservabilityDecl(metrics=False))
        platform = P.Platform.compile(spec, **kw)
        for call in (platform.advise, platform.advise_availability,
                     lambda: platform.advise_tiers(access_rate=1.0)):
            with pytest.raises(ValueError, match="no advisor"):
                call()
        sess = platform.kv_session("a")
        sess.save(np.zeros(256, np.float32))
        sess.resume()
        snap = platform.snapshot_stats()
        platform.reset_stats()
        return snap, platform.snapshot_stats(), platform.metrics, \
            platform.tracer
    _close(run(TP, device="cpu"), run(JP))


@pytest.mark.parametrize("name", ["topology_net", "quickstart_economic"])
def test_compiled_fabric_matches_reference(name):
    def run(P, **kw):
        platform = P.Platform.compile(_specs(P)[name], **kw)
        fab = platform.fabric
        rng = np.random.default_rng(4)
        for i in range(30):
            platform.kv_session(f"s{i}", host=i % fab.n_hosts).save(
                np.zeros(int(rng.integers(1, 32)) << 10, np.float32))
        platform.clock.advance(0.5)
        hs = [platform.kv_session(f"s{i}", host=(i + 1) % fab.n_hosts)
              .prefetch() for i in range(0, 30, 3)]
        platform.clock.advance(1e-4)
        for h in hs:
            h.result()
        return (platform.summary(), platform.report(),
                platform.snapshot_stats(), platform.ledger.as_dict(),
                platform.tracer.to_chrome_json()
                if platform.tracer is not None else None,
                fab.net_model.topology is not None, platform.step_time)
    got, want = run(TP, device="cpu"), run(JP)
    _close(got, want)


def test_unported_capabilities_raise_with_their_roadmap_item():
    platform = TP.Platform.compile(_specs(TP)["one_host_static"],
                                   device="cpu")
    # the expert store is ported (item 7f): the reference's, on a spec
    # with replicas (tests/test_torch_expert_store.py holds its scenarios)
    experts = {}
    for P, kw in ((TP, {"device": "cpu"}), (JP, {})):
        es = P.Platform.compile(_specs(P)["topology_net"], **kw
                                ).expert_store(2, 8, host=1,
                                               expert_bytes=4096.0)
        experts[P] = (type(es).__name__, es.host, es.store.replicas,
                      es.expert_bytes, es.counts.shape,
                      type(es.policy).__name__)
    assert experts[TP] == experts[JP] == (
        "ExpertStore", 1, 2, 4096.0, (2, 8), "EconomicGate")
    # the pool and the GPU-direct tier are ported (item 7d): the spec
    # compiles to the reference's gates, pool and tiers
    # (tests/test_torch_fourth_tier.py holds them to it on live fleets)
    pooled = {P: P.Platform.compile(_specs(P)["pool"], **kw)
              for P, kw in ((TP, {"device": "cpu"}), (JP, {}))}
    for P, plat in pooled.items():
        gate, pool = plat.policy(0), plat.fabric.pool
        pooled[P] = (gate.tau_be, gate.tau_pool, gate.gpu_direct,
                     pool.capacity_bytes, pool.lane_model.write_bw,
                     sorted(pool.lanes),
                     sorted(int(t) for t in plat.fabric.hosts[0].specs))
    assert pooled[TP] == pooled[JP]
    assert pooled[TP][2] and int(TTier.GPU_FLASH) in pooled[TP][-1]
    # repair and autoscale are ported: each returns the reference's
    # result (tests/test_torch_failover.py and test_torch_autoscale.py
    # hold them to it on live fleets)
    assert platform.repair().as_dict() == JP.Platform.compile(
        _specs(JP)["one_host_static"]).repair().as_dict()
    econ = {P: P.Platform.compile(_specs(P)["quickstart_economic"], **kw)
            for P, kw in ((TP, {"device": "cpu"}), (JP, {}))}
    assert econ[TP].autoscale().as_dict() == \
        econ[JP].autoscale().as_dict()
    # workload tenants compile (tests/test_torch_workload.py holds them to
    # the reference); a spec without a workload has no jobs
    assert len(TP.Platform.compile(_specs(TP)["workload"],
                                   device="cpu").jobs()) > 0
    with pytest.raises(ValueError, match="no workload"):
        platform.jobs()
    gpu = TP.HierarchySpec(hosts=(TP.HostDecl(
        tiers={"gpu_flash": TP.gpu_flash_tier()}),))
    store = TP.Platform.compile(gpu, device="cpu").fabric.hosts[0]
    assert type(store.runtime.models[TTier.GPU_FLASH]).__name__ \
        == "GpuDirectQueueModel"


def test_platform_device_goes_to_gates_and_engines(weights):
    _, cfg, _, tp = weights
    platform = TP.Platform.compile(_specs(TP)["quickstart_economic"],
                                   device="cpu")
    assert platform.device == torch.device("cpu")
    assert platform.tracker.hist.device.type == "cpu"
    assert platform.policy(1).tracker is platform.tracker
    eng = platform.engine(cfg, tp, max_slots=1, max_len=16, host=2)
    assert eng.device.type == "cpu" and eng.host == 2
    assert eng.store.fabric is platform.fabric
    with pytest.raises(ValueError, match="engine runs on meta"):
        platform.engine(cfg, tp, max_slots=1, max_len=16, device="meta")


def test_measured_step_time_matches_reference(tmp_path):
    for arch, bound in (("gemma-2b", 3e-3), ("qwen3-moe", 7e-3)):
        (tmp_path / f"{arch}__decode_32k__single.json").write_text(
            json.dumps({"roofline": {"step_time_bound": bound}}))
    (tmp_path / "bad__decode_32k__single.json").write_text("{nope")
    for kw in (dict(arch="gemma-2b"), dict(arch=None), dict(arch="none"),
               dict(arch=None, shape="prefill")):
        got = TP.measured_step_time(results_dir=str(tmp_path), **kw)
        assert got == JP.measured_step_time(results_dir=str(tmp_path),
                                            **kw)
    assert TP.measured_step_time(arch=None,
                                 results_dir=str(tmp_path)) == 7e-3
    spec = TP.HierarchySpec(step_time="measured",
                            roofline_results=str(tmp_path / "missing"),
                            step_time_fallback=4e-3)
    assert spec.resolved_step_time() == 4e-3


# ---------------------------------------------------------------------------
# the serve flow at reduced gemma-2b, float32
# ---------------------------------------------------------------------------

MAX_LEN = 64


@pytest.fixture(scope="module")
def weights():
    jcfg = j_get_config("gemma-2b", reduced=True)
    cfg = get_config("gemma-2b", reduced=True)
    jp, _ = JM.init_params(jax.random.PRNGKey(0), jcfg)
    tp = TM.params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return jcfg, cfg, jp, tp


def _serve_spec(P, cfg, small_dram):
    hosts = (P.HostDecl(),)
    if small_dram:
        blob = 2 * cfg.n_groups * 1 * MAX_LEN * 32 * 4      # f32 K and V
        hosts = (P.HostDecl(tiers={"dram": P.TierDecl(1.5 * blob, 45e9,
                                                      5e-7)}),)
    return P.HierarchySpec(
        hosts=hosts,
        policy=P.PolicyDecl.static(tau_hot=0.05, tau_be=1.0,
                                   ema_alpha=1.0),
        step_time=5e-3)


def _serve_flow(P, Req, make_engine, cfg, small_dram, **kw):
    """examples/serve_tiered_kv.py's flow, tokens and tiers recorded."""
    platform = P.Platform.compile(_serve_spec(P, cfg, small_dram), **kw)
    clock = platform.clock
    eng = make_engine(platform)
    rng = np.random.default_rng(0)
    reqs = [Req(rid=f"session-{i}",
                prompt=rng.integers(1, cfg.vocab, 8).astype(np.int32),
                max_new=12) for i in range(6)]
    done = eng.run(reqs)
    out = {"done": [r.rid for r in done], "steps": eng.steps}
    r0, r1 = done[0], done[1]
    eng.lengths[:] = 0
    eng.live[:] = False
    eng.slot_req.clear()
    eng.admit(r0)
    eng.admit(r1)
    tiers = [eng.pause(r0.rid), eng.pause(r1.rid)]
    eng.resume(r0.rid)
    eng.pause(r0.rid)
    clock.advance(1.2)
    eng.prefetch(r1.rid)
    clock.advance(3 * 5e-3)
    eng.resume(r1.rid)
    tiers.append(eng.store.tier_of(("kv", r0.rid)))
    out.update(
        tokens=[r.generated for r in reqs], tiers=[int(t) for t in tiers],
        stall=eng.kv_stall_time, now=clock.now(),
        lead=eng.prefetch_lead(r0.rid), locality=eng.locality_host(r0.rid),
        platform_report=platform.report(),
        runtime_report=eng.store.runtime.report(),
        summary=platform.summary(), ledger=platform.ledger.as_dict())
    return out


@pytest.fixture(scope="module", params=[False, True],
                ids=["default_tiers", "dram_1p5_blobs"])
def serve_runs(request, weights):
    jcfg, cfg, jp, tp = weights
    rules = single_device_rules()
    ref = _serve_flow(JP, JReq, lambda p: p.engine(
        jcfg, jp, rules, max_slots=4, max_len=MAX_LEN), jcfg,
        request.param)
    port = _serve_flow(TP, TReq, lambda p: p.engine(
        cfg, tp, max_slots=4, max_len=MAX_LEN), cfg, request.param,
        device="cpu")
    return ref, port, request.param


def test_serve_flow_tokens_equal_reference(serve_runs):
    ref, port, _ = serve_runs
    assert port["done"] == ref["done"] and port["steps"] == ref["steps"]
    assert port["tokens"] == ref["tokens"]


def test_serve_flow_tiers_and_stall_match_reference(serve_runs):
    ref, port, small_dram = serve_runs
    assert port["tiers"] == ref["tiers"]
    if small_dram:
        assert 2 in port["tiers"]             # a session reached FLASH
    assert math.isclose(port["stall"], ref["stall"], rel_tol=REL)
    assert math.isclose(port["now"], ref["now"], rel_tol=REL)
    assert port["lead"] == ref["lead"]
    assert port["locality"] == ref["locality"]


def test_serve_flow_reports_equal_reference(serve_runs):
    ref, port, _ = serve_runs
    assert port["platform_report"] == ref["platform_report"]
    assert port["runtime_report"] == ref["runtime_report"]
    _close(port["summary"], ref["summary"])
    _close(port["ledger"], ref["ledger"])


def _capture(fn):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn()
    return buf.getvalue().splitlines()


def _modeled(lines):
    """Everything but wall-clock speed and the tokens (the twin draws
    its own weights): the tiering lines and both report tables."""
    start = next(i for i, ln in enumerate(lines)
                 if ln.startswith("[tiering]"))
    return lines[start:]


def test_serve_example_twin_matches_reference_script(monkeypatch):
    from repro_torch.examples import serve_tiered_kv as twin
    got = _capture(lambda: twin.main(["--device", "cpu"]))
    monkeypatch.setattr(sys, "argv", ["serve_tiered_kv.py"])
    want = _capture(lambda: runpy.run_path(
        str(ROOT / "examples" / "serve_tiered_kv.py"),
        run_name="__main__"))
    assert _modeled(got) == _modeled(want)
    assert got[0].startswith("[serve] 6/6 requests, 72 tokens")
    assert "tok/s on CPU" in got[0]
    assert got[0].split(", ")[-1] == want[0].split(", ")[-1]


def test_quickstart_twin_matches_reference_script(tmp_path, monkeypatch):
    """Each side runs in its own directory and writes its trace there:
    every line and both traces are the same bytes."""
    from repro_torch.examples import quickstart as twin
    (tmp_path / "port").mkdir()
    (tmp_path / "ref").mkdir()
    monkeypatch.chdir(tmp_path / "port")
    got = _capture(lambda: twin.main(["--device", "cpu"]))
    monkeypatch.chdir(tmp_path / "ref")
    monkeypatch.setattr(sys, "argv", ["quickstart.py"])
    want = _capture(lambda: runpy.run_path(
        str(ROOT / "examples" / "quickstart.py"), run_name="__main__"))
    assert got == want
    assert any("causal trace: quickstart_trace.json" in ln for ln in got)
    trace = "quickstart_trace.json"
    assert (tmp_path / "port" / trace).read_bytes() == (
        tmp_path / "ref" / trace).read_bytes()


# ---------------------------------------------------------------------------
# cross-host resume on a 2-host fabric
# ---------------------------------------------------------------------------

def _cross_host(make_engine, Fabric, Clock, Policy, Req, route, vocab,
                routed):
    clock = Clock()
    fab = Fabric(2, clock=clock, policy_factory=lambda _h: Policy(
        tau_hot=1e-12, tau_be=1e-9, ema_alpha=1.0))
    eng0 = make_engine(fab.host_view(0))
    eng1 = make_engine(fab.host_view(1))
    rng = np.random.default_rng(0)
    reqs = [Req(rid=f"s{i}", prompt=rng.integers(1, vocab, 5).astype(
        np.int32), max_new=8) for i in range(2)]
    for r in reqs:
        eng0.admit(r)
    eng0.step()
    eng0.pause("s0")
    eng0.pause("s1")
    clock.advance(1.0)
    eng0.resume("s0")
    eng0.resume("s1")
    eng0.pause("s1")
    state = eng0.export_session("s1")
    if routed:
        target = route({0: eng0, 1: eng1}, "s1", state)
    else:
        eng1.import_session("s1", state)
        target = eng1
    clock.advance(1.0)
    target.resume("s1")
    while any(not r.done for r in reqs):
        for e in (eng0, eng1):
            if e.live.any():
                e.step()
    return {"tokens": [r.generated for r in reqs],
            "stalls": [eng0.kv_stall_time, eng1.kv_stall_time],
            "target": target.host, "now": clock.now(),
            "summary": fab.summary()}


@pytest.mark.parametrize("routed", [False, True],
                         ids=["import_session", "route_session"])
def test_cross_host_resume_matches_reference(weights, routed):
    """The reference's splice-reuse scenario: two engines on a 2-host
    fabric; pause, `export_session`, `import_session` (or
    `route_session`) and resume on the other host. Tokens and the
    modeled stall equal the reference's. The reference also counts its
    jit retraces there; torch traces no programs, so that assertion has
    no counterpart."""
    jcfg, cfg, jp, tp = weights
    rules = single_device_rules()
    ref = _cross_host(lambda st: JEngine(
        jcfg, jp, rules, max_slots=2, max_len=MAX_LEN, store=st,
        step_time=1e-3), JFabric, JClock, JPolicy, JReq, j_route,
        jcfg.vocab, routed)
    port = _cross_host(lambda st: TEngine(
        cfg, tp, max_slots=2, max_len=MAX_LEN, store=st, step_time=1e-3,
        device="cpu"), TFabric, TClock, TPolicy, TReq, t_route, cfg.vocab,
        routed)
    assert port["tokens"] == ref["tokens"]
    assert port["target"] == ref["target"]
    _close(port["stalls"], ref["stalls"])
    _close(port["summary"], ref["summary"])
    assert math.isclose(port["now"], ref["now"], rel_tol=REL)
    assert port["summary"]["remote_fetches"] + port["summary"][
        "local_fetches"] > 0


def test_traced_engine_sessions_match_reference(weights):
    """Admission, pause, prefetch and resume instants on the engine's
    track, with the session's causal flow, export the reference's
    bytes."""
    jcfg, cfg, jp, tp = weights
    rules = single_device_rules()

    def run(P, make, Req, vocab, **kw):
        spec = P.HierarchySpec(
            hosts=(P.HostDecl(count=2),),
            policy=P.PolicyDecl.pinned_flash(), step_time=1e-3,
            observability=P.ObservabilityDecl(trace=True))
        platform = P.Platform.compile(spec, **kw)
        eng = make(platform)
        req = Req(rid="t0", prompt=np.arange(1, 6, dtype=np.int32) % vocab,
                  max_new=4)
        eng.admit(req)
        eng.step()
        eng.pause("t0")
        platform.clock.advance(0.5)
        eng.prefetch_many(["t0"])
        platform.clock.advance(1e-3)
        eng.resume("t0")
        while not req.done:
            eng.step()
        return (platform.tracer.to_chrome_json(), req.generated,
                platform.ledger.as_dict())
    want = run(JP, lambda p: p.engine(jcfg, jp, rules, max_slots=1,
                                      max_len=16), JReq, jcfg.vocab)
    got = run(TP, lambda p: p.engine(cfg, tp, max_slots=1, max_len=16),
              TReq, cfg.vocab, device="cpu")
    assert got == want
    assert '"session:t0"' in got[0]


# ---------------------------------------------------------------------------
# the serving_async twin
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("argv", [[], ["--sessions", "4", "--rounds", "2"],
                                  ["--sessions", "3", "--rounds", "2",
                                   "--lead", "0"]],
                         ids=["defaults", "s4r2", "lead0"])
def test_serving_async_twin_json_byte_identical(argv, tmp_path,
                                                monkeypatch):
    from repro_torch.benchmarks import serving_async as twin
    port, ref = tmp_path / "port.json", tmp_path / "ref.json"
    got = _capture(lambda: twin.main(argv + ["--out", str(port)]))
    monkeypatch.setattr(sys, "argv",
                        ["serving_async.py"] + argv + ["--out", str(ref)])
    want = _capture(lambda: runpy.run_path(
        str(ROOT / "benchmarks" / "serving_async.py"),
        run_name="__main__"))
    assert port.read_bytes() == ref.read_bytes()
    assert got == want
    rec = json.loads(port.read_text())
    if "--lead" in argv:
        # a prefetch issued zero steps ahead is the synchronous restore
        assert rec["async"] | {"mode": "sync"} == rec["sync"]
    else:
        assert rec["async"]["per_token_stall"] < rec["sync"][
            "per_token_stall"]


@pytest.mark.parametrize("lead", [8, "p99", 0])
def test_session_bench_matches_reference(lead):
    kw = dict(n_sessions=5, rounds=2, kv_bytes=1 << 20, decode_steps=12,
              step_time=1e-3, lead=lead)
    assert t_sbench.compare(**kw) == j_sbench.compare(**kw)
