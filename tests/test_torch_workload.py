"""The port's workload compiler and per-tenant compile against the JAX
reference's: `platform/workload.py` (`compile_workload`,
`CompiledWorkload`, `tenant_classifier`), `autopilot.traces.from_workload`
and `Platform.compile` / `workload` / `jobs` on specs with tenants.

What must match, and how closely:
  * jobs (sid, tenant, prompt bytes, turns), traces, `id_steps` arrays,
    tenant names and SLOs: equal — the same numpy generators draw in the
    same order on both sides;
  * modeled float64 values (per-tenant `tau_be`, declared priors, the
    gates' thresholds, the tracker's quantiles and histogram): 1e-12
    relative.

The declarations are the reference tests' own (`tests/test_workload.py`
`_pack_decl`), carried to the port through the spec's JSON, which both
packages write byte for byte."""
import dataclasses
import math

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

import repro.platform as JP
from repro.autopilot.traces import from_workload as j_from_workload
from repro.core.economics import GPU_GDDR as J_GDDR
from repro.core.ssd_model import NAND_TYPES as J_NAND
from repro.core.ssd_model import storage_next_ssd as j_ssd
from repro.platform.workload import compile_workload as j_compile
from repro.platform.workload import tenant_classifier as j_classifier
import repro_torch.platform as TP
from repro_torch.autopilot.traces import from_workload as t_from_workload
from repro_torch.core.economics import GPU_GDDR as T_GDDR
from repro_torch.core.ssd_model import NAND_TYPES as T_NAND
from repro_torch.core.ssd_model import storage_next_ssd as t_ssd
from repro_torch.platform import CompiledWorkload
from repro_torch.platform import compile_workload as t_compile
from repro_torch.platform import tenant_classifier as t_classifier
from test_workload import _pack_decl

REL = 1e-12


def _port(decl):
    """The reference's WorkloadDecl, carried over as the spec's JSON."""
    blob = JP.HierarchySpec(workload=decl).to_json()
    return TP.HierarchySpec.from_json(blob).workload


def _kind_decl(kind, seed=0, n_sessions=3):
    """One tenant per arrival kind, with background and per-turn keys."""
    return JP.WorkloadDecl(
        tenants=(JP.TenantDecl(
            name="t0", n_sessions=n_sessions,
            session=JP.SessionShapeDecl(n_turns=3, gap_steps=3,
                                        gap_jitter=0.4,
                                        extra_keys_per_turn=2,
                                        extra_key_pool=16),
            arrival=JP.ArrivalDecl(kind=kind, background_per_step=3,
                                   background_pool=32)),),
        horizon_steps=40, seed=seed)


def _jobs(cw, vocab=64):
    return [(j.sid, j.tenant, j.prompt.dtype.str, j.prompt.tobytes(),
             tuple((t.due_step, t.max_new, t.deadline_steps)
                   for t in j.turns), j.state, j.turn_idx)
            for j in cw.jobs(vocab=vocab)]


def _assert_products_equal(got, want):
    assert _jobs(got) == _jobs(want)
    assert _jobs(got, vocab=256000) == _jobs(want, vocab=256000)
    tg, tw = got.trace(step_time=0.1, name="x"), want.trace(step_time=0.1,
                                                           name="x")
    assert (tg.name, tg.step_time, tg.steps) == (tw.name, tw.step_time,
                                                 tw.steps)
    sg, ng, ig = got.id_steps()
    sw, nw, iw = want.id_steps()
    assert (ng, ig) == (nw, iw) and len(sg) == len(sw)
    for a, b in zip(sg, sw):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def _close(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert math.isclose(got[k], want[k], rel_tol=REL, abs_tol=0.0), \
            (k, got[k], want[k])


CASES = ["pack", "pack_shared", "pack_seed1"] + [
    f"kind_{k}" for k in JP.ArrivalDecl.KINDS]


def _case(name):
    if name == "pack":
        return _pack_decl()
    if name == "pack_shared":
        return _pack_decl(isolation="shared")
    if name == "pack_seed1":
        return _pack_decl(seed=1)
    return _kind_decl(name[len("kind_"):])


@pytest.mark.parametrize("name", CASES)
def test_compiled_products_equal_reference(name):
    decl = _case(name)
    want, got = j_compile(decl), t_compile(_port(decl))
    assert isinstance(got, CompiledWorkload)
    _assert_products_equal(got, want)
    assert got.tenant_names() == want.tenant_names()
    assert {k: dataclasses.asdict(v) for k, v in got.slos().items()} \
        == {k: dataclasses.asdict(v) for k, v in want.slos().items()}
    for st_ in (0.0, 2e-3, 0.25):
        _close(got.declared_priors(st_), want.declared_priors(st_))
    for fetch in (0.0, 1e-4):
        _close(got.tenant_taus(T_GDDR, t_ssd(T_NAND["slc"]), 32768,
                               fetch_seconds=fetch),
               want.tenant_taus(J_GDDR, j_ssd(J_NAND["slc"]), 32768,
                                fetch_seconds=fetch))


def test_compiled_jobs_are_tenant_tagged_like_reference():
    """The reference test's shape checks, on the port's jobs."""
    jobs = t_compile(_port(_pack_decl())).jobs(vocab=64)
    assert len(jobs) == 3 + 2 + 4
    for j in jobs:
        tenant, idx = j.sid.split("/")
        assert j.tenant == tenant and len(idx) == 3
        dues = [t.due_step for t in j.turns]
        assert dues == sorted(dues) and len(set(dues)) == len(dues)
        assert j.prompt.dtype == np.int32
    assert all(t.deadline_steps == 4 for j in jobs
               if j.tenant == "premium" for t in j.turns)


@settings(max_examples=12, deadline=None)
@given(st.integers(min_value=0, max_value=1 << 16),
       st.sampled_from(JP.ArrivalDecl.KINDS),
       st.integers(min_value=1, max_value=5))
def test_compile_equals_reference_for_any_seed(seed, kind, n_sessions):
    decl = _kind_decl(kind, seed=seed, n_sessions=n_sessions)
    _assert_products_equal(t_compile(_port(decl)), j_compile(decl))


def test_tenant_classifier_matches_reference():
    names = ["premium", "scan"]
    got, want = t_classifier(names), j_classifier(names)
    keys = [("kv", "premium/003"), ("scan", 17), ("premium", 0),
            ("kv", "unknown/001"), ("kv", "r1"), ("kv", 5), (0, 3),
            ("expert", 1), "loose", ("a", "b", "c"), ("scan", "x/y")]
    assert [got(k) for k in keys] == [want(k) for k in keys]
    assert got(("kv", "premium/003")) == "premium"
    assert got(("scan", 17)) == "scan"
    assert got(("kv", "unknown/001")) == "kv"


@pytest.mark.parametrize("name", ["pack", "kind_diurnal"])
def test_from_workload_matches_reference(name):
    decl = _case(name)
    got = t_from_workload(_port(decl), step_time=0.5, name="w")
    want = j_from_workload(decl, step_time=0.5, name="w")
    assert (got.name, got.step_time, got.steps) == (want.name,
                                                    want.step_time,
                                                    want.steps)
    assert got.accesses == want.accesses


# ---------------------------------------------------------------------------
# Platform.compile with tenants
# ---------------------------------------------------------------------------

def _tenant_spec(isolation="per-tenant", **policy):
    return JP.HierarchySpec(
        policy=JP.PolicyDecl.economic(**policy), step_time=2e-3,
        class_priors={"kv": 0.5},
        workload=_pack_decl(isolation=isolation))


@pytest.mark.parametrize("isolation", ["per-tenant", "shared"])
@pytest.mark.parametrize("policy", [{}, {"alpha_stall": 1.0}],
                         ids=["plain", "alpha_stall"])
def test_compile_with_tenants_matches_reference(isolation, policy):
    spec = _tenant_spec(isolation, **policy)
    jplat = JP.Platform.compile(spec)
    tplat = TP.Platform.compile(
        TP.HierarchySpec.from_json(spec.to_json()), device="cpu")
    jg, tg = jplat.policy(0), tplat.policy(0)
    names = [t.name for t in spec.workload.tenants]
    if isolation == "per-tenant":
        assert set(tg.class_tau_be) == set(names)
        _close(tg.class_tau_be, jg.class_tau_be)
        assert tg.class_tau_be["premium"] > tg.class_tau_be["scan"]
    else:
        assert tg.class_tau_be is None and jg.class_tau_be is None
    assert math.isclose(tg.tau_be, jg.tau_be, rel_tol=REL)
    for key in (("kv", "premium/000"), ("kv", "scan/001"),
                ("kv", "nobody/000"), ("rag", 3), ("kv", "r1")):
        assert tg.classify(key) == jg.classify(key)
        assert math.isclose(tg.tau_for(key), jg.tau_for(key), rel_tol=REL)
    # the tracker: its class table, seeded priors and histogram
    jt, tt = jplat.tracker, tplat.tracker
    assert tt.max_classes == jt.max_classes == max(8, len(names) + 4)
    assert tt.classes == jt.classes
    np.testing.assert_allclose(tt.hist.numpy(), np.asarray(jt.hist),
                               rtol=REL, atol=0.0)
    for cls in ["kv"] + names:
        for q in (0.5, 0.9):
            a, b = tt.class_quantile(cls, q), jt.class_quantile(cls, q)
            assert (a is None and b is None) or math.isclose(
                a, b, rel_tol=REL), (cls, q, a, b)
    if isolation == "per-tenant":
        # declared think gaps seed per-tenant priors (gap_steps * step)
        for t in spec.workload.tenants:
            q = tt.class_quantile(t.name, 0.5)
            assert q == pytest.approx(t.session.gap_steps * 2e-3, rel=0.3)
    else:
        assert all(tt.class_quantile(n, 0.5) is None for n in names)


def test_platform_jobs_require_a_declared_workload():
    plat = TP.Platform.compile(TP.HierarchySpec(), device="cpu")
    with pytest.raises(ValueError, match="no workload") as got:
        plat.jobs()
    with pytest.raises(ValueError, match="no workload") as want:
        JP.Platform.compile(JP.HierarchySpec()).jobs()
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="no workload"):
        plat.workload()
    spec = JP.HierarchySpec(workload=_pack_decl())
    plat2 = TP.Platform.compile(TP.HierarchySpec.from_json(spec.to_json()),
                                device="cpu")
    assert plat2.workload() is plat2.workload()        # cached
    assert len(plat2.jobs()) == 9
    assert _jobs(plat2.workload()) == _jobs(
        JP.Platform.compile(spec).workload())
