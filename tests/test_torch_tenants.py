"""The port's tenant-isolation bench (`serving/tenants.py`) and its twin
(`python -m repro_torch.benchmarks.serving_tenants`) against the JAX
reference's `serving/tenants.py` and `benchmarks/serving_tenants.py`.

What must match, and how closely:
  * `tenant_pack`: its spec JSON, byte for byte;
  * `run_tenant_bench` on the reference's PRNGKey(0) weights (through
    `params_from_jax`, on the CPU): the returned dict, key for key and
    float for float;
  * the twin against the reference script run in-process with runpy:
    the JSON on stdout, the `--out` file and each arm's `--trace` export
    byte for byte, and the table on stderr line for line. The twin draws
    its own weights: the bench's JSON holds no token, so it does not
    depend on them.
The reference script runs once per argv (a module-scoped fixture), and
the reference's `run_tenant_bench` dict is the one that run returned."""
import contextlib
import io
import json
import pathlib
import runpy
import sys

import jax
import numpy as np
import pytest
import torch

import repro.serving.tenants as jt
from repro.configs import get_config as j_get_config
from repro.models import model as JM
from repro_torch.benchmarks import serving_tenants as twin
from repro_torch.configs import get_config
from repro_torch.models import model as TM
from repro_torch.serving import tenants as tt

ROOT = pathlib.Path(__file__).resolve().parents[1]
TRACE = ["--smoke", "--trace", "--trace-out", "tr/tenants"]
ARMS = ("gated", "no_adversary", "shared")


def _run(fn):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        fn()
    return out.getvalue(), err.getvalue().splitlines()


def _side_run(side, argv, cwd, monkeypatch, params=None):
    """One run of the twin (`side` "port") or the reference script ("ref")
    in `cwd` with `argv --out report.json`. Returns (stdout, stderr lines,
    the --out bytes, the dict run_tenant_bench returned, trace files by
    name)."""
    cwd.mkdir()
    (cwd / "tr").mkdir()
    monkeypatch.chdir(cwd)
    args = argv + ["--out", "report.json"]
    got = {}
    if side == "port":
        inner = tt.run_tenant_bench

        def noted(*a, **k):
            got["report"] = inner(*a, params=params, **k)
            return got["report"]
        monkeypatch.setattr(twin, "run_tenant_bench", noted)
        out, err = _run(lambda: twin.main(args + ["--device", "cpu"]))
    else:
        inner = jt.run_tenant_bench

        def noted(*a, **k):
            got["report"] = inner(*a, **k)
            return got["report"]
        monkeypatch.setattr(jt, "run_tenant_bench", noted)
        monkeypatch.setattr(sys, "argv", ["serving_tenants.py"] + args)
        out, err = _run(lambda: runpy.run_path(
            str(ROOT / "benchmarks" / "serving_tenants.py"),
            run_name="__main__"))
    traces = {p.name: p.read_bytes() for p in sorted((cwd / "tr").iterdir())}
    return out, err, (cwd / "report.json").read_bytes(), got["report"], \
        traces


@pytest.fixture(scope="module")
def ref_params():
    jcfg, cfg = (j_get_config("gemma-2b", reduced=True),
                 get_config("gemma-2b", reduced=True))
    jp, _ = JM.init_params(jax.random.PRNGKey(0), jcfg)
    return TM.params_from_jax(jax.tree.map(np.asarray, jp), cfg,
                              device="cpu")


ARGVS = {"smoke": ["--smoke"], "smoke_trace": TRACE}


@pytest.fixture(scope="module")
def runs(ref_params, tmp_path_factory):
    """runs(name): the reference script and the twin on ARGVS[name], each
    run once in the module; the twin's run_tenant_bench on the
    reference's weights."""
    done = {}

    def get(name):
        if name not in done:
            with pytest.MonkeyPatch.context() as mp:
                base = tmp_path_factory.mktemp(name)
                done[name] = {side: _side_run(side, ARGVS[name],
                                              base / side, mp,
                                              params=ref_params)
                              for side in ("ref", "port")}
        return done[name]
    return get


@pytest.mark.parametrize("kw", [
    {},
    dict(premium_sessions=2, batch_sessions=1, scan_sessions=16,
         dram_blobs=5, p99_stall_budget=1e-6, horizon_steps=48, seed=3),
], ids=["default", "custom"])
def test_tenant_pack_json_equals_reference(kw):
    assert tt.KV_BLOB_BYTES == jt.KV_BLOB_BYTES
    assert tt.STEP_TIME == jt.STEP_TIME
    assert tt.tenant_pack(**kw).to_json() == jt.tenant_pack(**kw).to_json()


def test_run_tenant_bench_matches_reference(runs):
    """run_tenant_bench on the reference's weights, on the CPU: the dict
    key for key and float for float, and the reference tests' verdicts
    (tests/test_workload.py::test_isolation_headline_holds)."""
    sides = runs("smoke")
    got, want = sides["port"][3], sides["ref"][3]
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)
    assert got == want
    v = got["verdicts"]["premium"]
    assert v["gated_meets_budget"] and v["shared_violates"] \
        and v["adversary_causal"] and got["isolation_effective"]
    assert got["gated"]["tau_be"]["premium"] > got["gated"]["tau_be"]["scan"]
    for arm in ARMS:
        m = got[arm]["report"]
        rhs = m["kv_stall"] + tt.STEP_TIME * m["slot_idle_steps"]
        assert abs(m["stall_ledger"]["total"] - rhs) <= 1e-9 * max(rhs,
                                                                   1e-30)


@pytest.mark.parametrize("name", list(ARGVS))
def test_twin_matches_reference_script(runs, name):
    """stdout, the --out bytes, stderr, and each arm's trace export."""
    argv, sides = ARGVS[name], runs(name)
    out, err, blob, _, traces = sides["port"]
    ref_out, ref_err, ref_blob, _, ref_traces = sides["ref"]
    assert blob == ref_blob
    assert out == ref_out
    assert err == ref_err
    assert err[-1] == "isolation effective: True"
    assert traces == ref_traces
    if "--trace" in argv:
        assert sorted(traces) == [f"tenants_{a}.json" for a in ARMS]
        assert all(b'"cat": "policy"' in t and b'"cat": "transfer"' in t
                   for t in traces.values())
    else:
        assert traces == {}


def test_twin_native_weights_give_the_same_json(runs, tmp_path,
                                                monkeypatch):
    """The twin as a user runs it (its own seed-0 weights, drawn on the
    CPU): the same bytes as on the reference's weights."""
    sides = runs("smoke")
    monkeypatch.chdir(tmp_path)
    out, _ = _run(lambda: twin.main(["--smoke", "--device", "cpu",
                                     "--out", "native.json"]))
    assert (tmp_path / "native.json").read_bytes() == sides["ref"][2]
    assert out == sides["ref"][0]


def test_twin_refuses_without_cuda(monkeypatch):
    """No CPU fallback: without CUDA the twin runs only when asked for the
    CPU, and refuses before it decodes anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    called = []
    monkeypatch.setattr(TM, "init_params", lambda *a, **k: called.append(a))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        twin.main(["--smoke"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tt.run_tenant_bench()
    assert not called


def test_twin_device_flag():
    with pytest.raises(SystemExit):
        with contextlib.redirect_stderr(io.StringIO()):
            twin.main(["--smoke", "--device", "tpu"])
