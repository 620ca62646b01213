"""The port's fleet bench (`serving/bench.py`: `multi_host_session_bench`,
`compare_fleet`, `compare_churn`) and its twin (`python -m
repro_torch.benchmarks.serving_fleet`) against the JAX reference's.

Each case runs the reference's function and the port's on the same
arguments and holds the port's record equal to the reference's, key for
key (in the reference's order) and float for float: the bench is modeled
Python on a virtual clock, so nothing is left to a tolerance. The twin's
JSON equals the reference script's byte for byte and its stderr table
line for line. A `spec=` fleet with economic gates keeps its reuse
sketch on `device="cpu"` here; chip_smoke.py phase 14 holds the card's
records to the CPU's."""
import contextlib
import importlib.util
import io
import json
import pathlib
import sys

import pytest

import repro.platform as JP
import repro.serving.bench as JB
import repro_torch.platform as TP
import repro_torch.serving.bench as TB
from repro.core.policy import Tier as JTier
from repro_torch.benchmarks import serving_fleet as twin
from repro_torch.core.policy import Tier as TTier

ROOT = pathlib.Path(__file__).resolve().parents[1]
# the reference tests' fleet geometry (tests/test_platform.py)
KW = dict(n_sessions=8, rounds=2, kv_bytes=1 << 19, decode_steps=8,
          step_time=2e-3, seed=0)


def _same(got, want):
    """Equal records: the same keys in the same order, equal values."""
    assert json.dumps(got) == json.dumps(want)
    assert got == want


def _port_spec(spec):
    return TP.HierarchySpec.from_json(spec.to_json())


def _het_spec(weighting):
    """tests/test_platform.py's heterogeneous fleet: one host with 2x
    the DRAM of three others, each small host holding three sessions."""
    small = 3 * (1 << 19)
    return JP.HierarchySpec(
        hosts=(JP.HostDecl(tiers={"dram": JP.TierDecl(2 * small, 45e9,
                                                       5e-7)}),
               JP.HostDecl(tiers={"dram": JP.TierDecl(small, 45e9, 5e-7)},
                           count=3)),
        policy=JP.PolicyDecl.pinned_dram(), weighting=weighting,
        vnodes=128)


@pytest.mark.parametrize("locality", [False, True],
                         ids=["scheduled", "locality"])
@pytest.mark.parametrize("lead", [6, "p99"], ids=["lead6", "p99"])
@pytest.mark.parametrize("skew", [0.0, 1.2], ids=["uniform", "zipf"])
def test_compare_fleet_matches_reference(skew, lead, locality):
    kw = dict(KW, n_hosts=4, lead=lead, skew=skew, locality=locality)
    got = TB.compare_fleet(**kw)
    _same(got, JB.compare_fleet(**kw))
    assert got["stall_speedup"] > 1.0


@pytest.mark.parametrize("churn,rate", [
    ({"join_turn": 8}, None),
    ({"join_turn": 8, "leave_turn": 8}, None),
    ({"join_turn": 6, "leave_turn": 12}, 2e9),
], ids=["join", "join_then_leave_same_turn", "paced"])
def test_compare_churn_matches_reference(churn, rate):
    kw = dict(KW, n_hosts=4, lead="p99", skew=1.2, locality=True,
              rebalance_rate=rate)
    got = TB.compare_churn(churn, **kw)
    _same(got, JB.compare_churn(churn, **kw))
    events = got["churn"]["rebalance_events"]
    assert [e["action"] for e in events] == \
        ["join"] + (["leave"] if "leave_turn" in churn else [])
    assert got["churn"]["final_hosts"] == 4.0 + ("leave_turn" not in churn)


def test_compare_churn_reuses_baseline():
    """`baseline=` skips the no-churn run; the record is the same."""
    kw = dict(KW, n_hosts=4, lead=6)
    base = TB.multi_host_session_bench("async", **kw)
    _same(TB.compare_churn({"join_turn": 8}, baseline=base, **kw),
          JB.compare_churn({"join_turn": 8}, **kw))


def test_homogeneous_spec_gives_keyword_record():
    """A homogeneous pinned-flash spec reproduces the keyword path."""
    kw = dict(KW, lead=6, skew=1.2)
    spec = JP.HierarchySpec(hosts=(JP.HostDecl(count=4),),
                            policy=JP.PolicyDecl.pinned_flash())
    classic = TB.multi_host_session_bench("async", n_hosts=4, **kw)
    declared = TB.multi_host_session_bench(
        "async", spec=_port_spec(spec), device="cpu", **kw)
    _same(declared, classic)
    _same(declared, JB.multi_host_session_bench("async", spec=spec, **kw))


@pytest.mark.parametrize("weighting", ["capacity", "uniform"])
def test_heterogeneous_dram_spec_matches_reference(weighting):
    kw = dict(n_sessions=14, rounds=3, kv_bytes=1 << 19, decode_steps=8,
              step_time=2e-3, lead=6, seed=0)
    spec = _het_spec(weighting)
    got = TB.multi_host_session_bench(
        "sync", spec=_port_spec(spec), kv_tier=TTier.DRAM, device="cpu",
        **kw)
    _same(got, JB.multi_host_session_bench("sync", spec=spec,
                                           kv_tier=JTier.DRAM, **kw))


def test_capacity_weighting_beats_uniform_on_skewed_dram():
    """The reference's acceptance shape on the port: the capacity-weighted
    ring stalls less than the uniform one on the 2:1 DRAM fleet."""
    kw = dict(kv_tier=TTier.DRAM, n_sessions=14, rounds=3,
              kv_bytes=1 << 19, decode_steps=8, step_time=2e-3, lead=6,
              seed=0, device="cpu")
    weighted = TB.multi_host_session_bench(
        "sync", spec=_port_spec(_het_spec("capacity")), **kw)
    uniform = TB.multi_host_session_bench(
        "sync", spec=_port_spec(_het_spec("uniform")), **kw)
    assert weighted["per_token_stall"] < uniform["per_token_stall"]


def test_economic_spec_fleet_matches_reference():
    """Four hosts under the economic policy: each host's gate keeps its
    reuse sketch on the device named; the record is the reference's."""
    spec = JP.HierarchySpec(hosts=(JP.HostDecl(count=4),),
                            policy=JP.PolicyDecl.economic(l_blk=1 << 20))
    kw = dict(n_sessions=8, rounds=2, kv_bytes=1 << 20, decode_steps=16,
              step_time=2e-3, lead=8, seed=0)
    got = TB.compare_fleet(spec=_port_spec(spec), device="cpu", **kw)
    _same(got, JB.compare_fleet(spec=spec, **kw))


def test_spec_conflict_raises_reference_message():
    spec = JP.HierarchySpec(hosts=(JP.HostDecl(count=2),),
                            policy=JP.PolicyDecl.pinned_flash())
    kw = dict(n_sessions=2, rounds=1, n_hosts=2, rebalance_rate=1e9)
    with pytest.raises(ValueError) as want:
        JB.multi_host_session_bench("async", spec=spec, **kw)
    with pytest.raises(ValueError) as got:
        TB.multi_host_session_bench("async", spec=_port_spec(spec),
                                    device="cpu", **kw)
    assert str(got.value) == str(want.value)
    assert "['n_hosts', 'rebalance_rate']" in str(got.value)


def test_spec_path_raises_without_cuda(monkeypatch):
    """A spec= fleet's gates keep their sketch on CUDA unless the caller
    asks for the CPU: without CUDA and without `device=` it raises."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = TP.HierarchySpec(hosts=(TP.HostDecl(count=2),),
                            policy=TP.PolicyDecl.pinned_flash())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TB.multi_host_session_bench("async", spec=spec, n_sessions=2,
                                    rounds=1)


def _load_reference_cli():
    path = ROOT / "benchmarks" / "serving_fleet.py"
    spec = importlib.util.spec_from_file_location("serving_fleet_ref", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(fn):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        fn()
    return out.getvalue(), err.getvalue().splitlines()


@pytest.mark.parametrize("argv", [
    ["--smoke"],
    ["--smoke", "--churn"],
    ["--smoke", "--lead", "p99", "--locality", "--join-turn", "4",
     "--leave-turn", "10", "--pace-gbs", "2"],
    ["--smoke", "--spec", "SPEC", "--kv-tier", "dram"],
], ids=["smoke", "smoke_churn", "smoke_p99_locality_paced", "spec_dram"])
def test_serving_fleet_twin_byte_identical(argv, tmp_path, monkeypatch):
    spec_path = tmp_path / "fleet_spec.json"
    spec_path.write_text(_het_spec("capacity").to_json())
    argv = [str(spec_path) if a == "SPEC" else a for a in argv]
    ref_cli = _load_reference_cli()
    runs = {}
    for side in ("port", "ref"):
        out = tmp_path / f"{side}.json"
        if side == "port":
            runs[side] = _run(lambda: twin.main(
                argv + ["--out", str(out), "--device", "cpu"]))
        else:
            monkeypatch.setattr(sys, "argv", ["serving_fleet.py"] + argv
                                + ["--out", str(out)])
            runs[side] = _run(ref_cli.main)
    assert runs["port"] == runs["ref"]
    assert (tmp_path / "port.json").read_bytes() == \
        (tmp_path / "ref.json").read_bytes()
    report = json.loads(runs["port"][0])
    if "--churn" in argv:
        assert all("churn" in cell for cell in report["trajectory"])


def test_serving_fleet_twin_device_flag():
    with pytest.raises(SystemExit):
        with contextlib.redirect_stderr(io.StringIO()):
            twin.main(["--smoke", "--device", "tpu"])
