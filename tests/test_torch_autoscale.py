"""The port's closed provisioning loop (`platform/autoscale.py` behind
`Platform.autoscale`) against the JAX reference's.

What must match, and how closely:
  * `run_autoscale_bench` JSON: byte for byte (`obs.bench_json` on both
    sides), at the reference's defaults and on every scenario;
  * every `AutoscaleDecision.as_dict()`: value for value (the same
    modeled Python on both sides; floats equal, not close).

The reference's own acceptance checks (`tests/test_platform.py`, the
autoscale section) run on the port's results. Everything runs on the
CPU (`device="cpu"`), where the fleet tracker's sketch takes its plain
version; chip_smoke.py phase 11 holds the CUDA run's JSON to the CPU's."""
import dataclasses
import json
from types import SimpleNamespace

import pytest
import torch

import repro.platform as JP
import repro_torch.platform as TP
from repro.obs import bench_json as j_bench_json
from repro_torch import kernels as K
from repro_torch.obs import bench_json


@pytest.fixture(scope="module")
def diurnal():
    """The reference's acceptance run (diurnal, 240 steps), both sides."""
    return (TP.run_autoscale_bench(n_steps=240, device="cpu"),
            JP.run_autoscale_bench(n_steps=240))


def test_autoscale_bench_json_byte_identical_at_defaults(diurnal):
    got, want = diurnal
    assert bench_json(got) == j_bench_json(want)


def test_autoscale_diurnal_closed_loop_acceptance(diurnal):
    """On the diurnal trace the loop adds a host during the peak,
    removes it off-peak, ends within one host of the advisor's final
    recommendation, at <= the static fleet's modeled $/token."""
    r, _ = diurnal
    a = r["autoscaled"]
    actions = [d["action"] for d in a["decisions"]]
    assert "add" in actions, a["decisions"]
    assert "remove" in actions, a["decisions"]
    add_step = next(d["step"] for d in a["decisions"]
                    if d["action"] == "add")
    remove_step = next(d["step"] for d in a["decisions"]
                       if d["action"] == "remove")
    # the peak is the diurnal overlap (middle third); off-peak follows
    assert 240 / 3 <= add_step < remove_step
    assert a["hosts_peak"] > a["hosts_start"]
    assert a["hosts_final"] < a["hosts_peak"]
    assert r["final_within_one_of_advice"]
    assert r["autoscale_wins"], (a["cost_per_token"],
                                 r["static"]["cost_per_token"])
    # the figures the reference computes at its defaults
    assert [(d["action"], d["n_hosts"]) for d in a["decisions"]] == [
        ("add", 2), ("remove", 1)]
    assert round(r["cost_ratio_vs_static"], 3) == 0.982


def test_autoscale_bench_deterministic_in_process():
    kw = dict(n_steps=60, every=10)
    a = TP.run_autoscale_bench(device="cpu", **kw)
    b = TP.run_autoscale_bench(device="cpu", **kw)
    assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)
    assert bench_json(a) == j_bench_json(JP.run_autoscale_bench(**kw))


@pytest.mark.parametrize("scenario", ["zipf", "scan_flood", "multi_tenant"])
def test_autoscale_bench_matches_reference_on_each_scenario(scenario):
    kw = dict(scenario=scenario, n_steps=60, every=5)
    got = TP.run_autoscale_bench(device="cpu", **kw)
    assert bench_json(got) == j_bench_json(JP.run_autoscale_bench(**kw))


def test_autoscale_bench_without_pacer_matches_reference():
    """`rebalance_rate=None`: rebalances stream unpaced on both sides."""
    kw = dict(n_steps=120, every=10)
    got = TP.run_autoscale_bench(
        TP.default_autoscale_spec(rebalance_rate=None, cooldown_steps=10),
        device="cpu", **kw)
    want = JP.run_autoscale_bench(
        JP.default_autoscale_spec(rebalance_rate=None, cooldown_steps=10),
        **kw)
    assert bench_json(got) == j_bench_json(want)


def test_autoscale_spec_json_matches_reference():
    assert TP.default_autoscale_spec(64 << 10).to_json() == \
        JP.default_autoscale_spec(64 << 10).to_json()


def _stepped(P, spec_of, advice_seq, **kw):
    """Compile `spec_of(P)`, stub the advisor with `advice_seq` (one
    advice per step) and collect each decision and the fleet size."""
    p = P.Platform.compile(spec_of(P), **kw)
    out = []
    for step, adv in enumerate(advice_seq):
        p.advise = lambda horizon=None, _a=adv: _a
        d = p.autoscale(step)
        out.append((d.as_dict(), p.n_hosts))
    return out


def _hetero_spec(P):
    blk = 1 << 20
    return P.HierarchySpec(
        hosts=(P.HostDecl(tiers={"dram": P.TierDecl(20 * blk, 45e9, 5e-7)}),
               P.HostDecl(tiers={"dram": P.TierDecl(5 * blk, 45e9, 5e-7)},
                          count=3)),
        policy=P.PolicyDecl.economic(l_blk=blk),
        autoscale=P.AutoscaleDecl(min_hosts=1, max_hosts=8,
                                  cooldown_steps=0, template=0))


def _capacity_advice(target_blocks):
    return SimpleNamespace(recommended_hosts=2,
                           recommended_dram_bytes=target_blocks * (1 << 20),
                           limit="none", bandwidth_limited=False)


def test_autoscaler_never_underprovisions_heterogeneous_fleet():
    """The advisor's host count is denominated in template-host DRAM;
    on a mixed fleet, count-matching by retiring small hosts would
    strand the hot set below its byte target. The loop must hold
    instead (and still retire when capacity allows)."""
    # target 33.3 blocks: dropping any 5-block host under-provisions;
    # target 20 blocks: the newest small host can safely retire
    seq = [_capacity_advice(33.3), _capacity_advice(20.0)]
    got = _stepped(TP, _hetero_spec, seq, device="cpu")
    assert got == _stepped(JP, _hetero_spec, seq)
    (hold, n0), (remove, n1) = got
    assert hold["action"] == "hold" and n0 == 4
    assert remove["action"] == "remove" and n1 == 3


def test_autoscaler_respects_cooldown_and_bounds():
    def clamped(P):
        return dataclasses.replace(
            P.HierarchySpec(hosts=(P.HostDecl(count=2),),
                            policy=P.PolicyDecl.economic(l_blk=1 << 16)),
            autoscale=P.AutoscaleDecl(min_hosts=2, max_hosts=2,
                                      cooldown_steps=5))

    # empty fleet: advisor recommends 1 but min_hosts clamps to 2
    p = TP.Platform.compile(clamped(TP), device="cpu")
    d = p.autoscale(0)
    assert d.action == "hold" and p.n_hosts == 2
    assert d.recommended == 2
    assert d.as_dict() == JP.Platform.compile(clamped(JP)).autoscale(0) \
        .as_dict()

    def cooled(P):
        blk = 1 << 20
        return P.HierarchySpec(
            hosts=(P.HostDecl(tiers={"dram": P.TierDecl(
                10 * blk, 45e9, 5e-7)}),),
            policy=P.PolicyDecl.economic(l_blk=blk),
            autoscale=P.AutoscaleDecl(min_hosts=1, max_hosts=2,
                                      cooldown_steps=3))

    # short of capacity every step: add at 0, cooldown holds 1-2, then
    # the bound (max_hosts=2) holds
    seq = [_capacity_advice(30.0)] * 5
    got = _stepped(TP, cooled, seq, device="cpu")
    assert got == _stepped(JP, cooled, seq)
    assert [(d["action"], n) for d, n in got] == [
        ("add", 2), ("hold", 2), ("hold", 2), ("hold", 2), ("hold", 2)]
    assert "cooldown (1/3" in got[1][0]["reason"]
    assert "rebalance" in got[0][0] and "rebalance" not in got[1][0]


def test_autoscaler_acts_on_bandwidth_limited_verdicts():
    """A `dram-bandwidth` verdict adds a host even when capacity covers
    the hot set, and at max_hosts the loop holds and says why — the
    remove branch must not fire despite the headroom."""
    def spec(P):
        blk = 1 << 20
        return P.HierarchySpec(
            hosts=(P.HostDecl(tiers={"dram": P.TierDecl(
                20 * blk, 45e9, 5e-7)}, count=2),),
            policy=P.PolicyDecl.economic(l_blk=blk),
            autoscale=P.AutoscaleDecl(min_hosts=1, max_hosts=3,
                                      cooldown_steps=0))

    def advice(target_blocks, limit):
        return SimpleNamespace(
            recommended_hosts=2,
            recommended_dram_bytes=target_blocks * (1 << 20),
            limit=limit, t_b=0.5, t_s=1.5,
            bandwidth_limited=limit in ("dram-bandwidth",
                                        "ssd-bandwidth"))

    seq = [advice(10.0, "dram-bandwidth"), advice(10.0, "dram-bandwidth"),
           advice(10.0, "none")]
    got = _stepped(TP, spec, seq, device="cpu")
    assert got == _stepped(JP, spec, seq)
    (add, n0), (hold, n1), (remove, n2) = got
    assert add["action"] == "add" and n0 == 3
    assert "dram-bandwidth-limited" in add["reason"]
    assert "T_B" in add["reason"]
    assert hold["action"] == "hold" and n1 == 3
    assert "max_hosts" in hold["reason"]
    # the verdict clears: the headroom retires the newest host
    assert remove["action"] == "remove" and n2 == 2


def test_platform_autoscale_keeps_one_loop_and_counts_steps():
    """`Platform.autoscale()` with no step numbers its own calls, and
    the decisions accumulate on the platform's one `Autoscaler`."""
    def spec(P):
        return P.default_autoscale_spec(1 << 16)

    def run(P, **kw):
        p = P.Platform.compile(spec(P), **kw)
        ds = [p.autoscale().as_dict() for _ in range(3)]
        return ds, [d.as_dict() for d in p._autoscaler.decisions]

    got = run(TP, device="cpu")
    assert got == run(JP)
    assert [d["step"] for d in got[0]] == [0, 1, 2]
    assert got[0] == got[1]


def test_autoscale_bench_on_cpu_launches_no_kernel():
    """On the CPU the fleet tracker takes the sketch's plain version;
    the wrapper counts only kernel launches."""
    K.reset_launch_counts()
    TP.run_autoscale_bench(n_steps=30, every=10, device="cpu")
    assert K.launch_counts()["reuse_sketch"] == 0


def test_autoscale_bench_needs_a_device_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TP.run_autoscale_bench(n_steps=10)
