"""The port's continuous-batching scheduler against the JAX reference's:
`serving/scheduler.py` (`ContinuousScheduler`, `run_lockstep`,
`compare_scheduling`, `jobs_from_trace`) over the port's `DecodeEngine`,
`Platform.scheduler`, and the whole slice — a declared multi-tenant spec
through `Platform.compile` -> `Platform.scheduler` ->
`run(Platform.jobs(...))`.

Each scenario is one of the reference tests' (`tests/test_serving_scheduler.py`,
`tests/test_tenant_report.py`, `tests/test_workload.py`), run by the
reference's scheduler over the reference's engine and by the port's over
the port's, on the same jobs. Reduced gemma-2b in float32: the JAX side
with `init_params` weights, the port with the same weights through
`params_from_jax`, on `device="cpu"`.

What must match, and how closely:
  * tokens per session, integer counters and states: equal;
  * modeled float64 values (stalls, ledgers, rates): 1e-12 relative;
  * the scheduler's Perfetto export: byte for byte."""
import dataclasses
import math
import types

import jax
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

import repro.platform as JP
import repro.serving.scheduler as JS
from repro.autopilot.traces import SCENARIOS
from repro.configs import get_config as j_get_config
from repro.core.policy import TieringPolicy as JPolicy
from repro.models import model as JM
from repro.parallel.sharding import single_device_rules
from repro.runtime import ShardedTieredStore as JFabric
from repro.runtime import TieredStore as JStore
from repro.runtime import VirtualClock as JClock
from repro.serving.engine import DecodeEngine as JEngine
from repro.serving.engine import Request as JReq
import repro_torch.platform as TP
import repro_torch.serving as TS
from repro_torch.configs import get_config
from repro_torch.core.policy import TieringPolicy as TPolicy
from repro_torch.models import model as TM
from repro_torch.runtime import ShardedTieredStore as TFabric
from repro_torch.runtime import TieredStore as TStore
from repro_torch.runtime import VirtualClock as TClock
from repro_torch.serving import DecodeEngine as TEngine
from repro_torch.serving import Request as TReq
from test_workload import _pack_decl

REL = 1e-12
MAX_LEN = 64


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
        assert math.isclose(got, want, rel_tol=REL, abs_tol=0.0), \
            (path, got, want)
    else:
        assert got == want, (path, got, want)


def _sides(arch):
    """(reference, port): each a namespace of its package's pieces and
    engine/platform builders over the same reduced `arch` weights."""
    jcfg = j_get_config(arch, reduced=True)
    cfg = get_config(arch, reduced=True)
    jp, _ = JM.init_params(jax.random.PRNGKey(0), jcfg)
    tp = TM.params_from_jax(jax.tree.map(np.asarray, jp), cfg,
                            device="cpu")
    rules = single_device_rules()
    # a config with recurrent state (Mamba-2, xLSTM), whose parked
    # sessions the reference advances on a stale token (see
    # _declared_workload...)
    recurrent = any(s.kind in ("mamba2", "mlstm", "slstm")
                    for *_, s in cfg.sublayers())
    ref = types.SimpleNamespace(
        S=JS, Policy=JPolicy, Store=JStore, Clock=JClock, Fabric=JFabric,
        Request=JReq, vocab=jcfg.vocab, recurrent=recurrent,
        engine=lambda **kw: JEngine(jcfg, jp, rules, **kw),
        compile=JP.Platform.compile,
        scheduler=lambda plat, **kw: plat.scheduler(jcfg, jp, rules, **kw))
    port = types.SimpleNamespace(
        S=TS, Policy=TPolicy, Store=TStore, Clock=TClock, Fabric=TFabric,
        Request=TReq, vocab=cfg.vocab, recurrent=recurrent,
        engine=lambda **kw: TEngine(cfg, tp, device="cpu", **kw),
        compile=lambda spec: TP.Platform.compile(
            TP.HierarchySpec.from_json(spec.to_json()), device="cpu"),
        scheduler=lambda plat, **kw: plat.scheduler(cfg, tp, **kw))
    return ref, port


@pytest.fixture(scope="module")
def sides():
    return _sides("gemma-2b")


def _both(sides, fn):
    """fn(side) on the reference and the port; the port's result is held
    to the reference's and returned."""
    ref, port = sides
    want, got = fn(ref), fn(port)
    _close(got, want)
    return got


def _pinned_flash(side):
    return side.Policy(tau_hot=1e-12, tau_be=1e-9, ema_alpha=1.0)


def _engine(side, *, max_slots=2, store=None, step_time=2e-3, clock=None):
    return side.engine(max_slots=max_slots, max_len=MAX_LEN,
                       policy=_pinned_flash(side), store=store,
                       clock=clock, step_time=step_time)


def _jobs(side, specs):
    """SessionJobs from plain data: (sid, prompt, [(due, new, deadline)],
    tenant)."""
    return [side.S.SessionJob(
        sid=sid, prompt=prompt.copy(), tenant=tenant,
        turns=[side.S.Turn(due_step=d, max_new=n, deadline_steps=dl)
               for d, n, dl in turns])
        for sid, prompt, turns, tenant in specs]


def _outcome(sched, jobs):
    return {
        "tokens": {j.sid: list(j.request.generated)
                   if j.request is not None else None for j in jobs},
        "jobs": {j.sid: (j.state, j.turn_idx, j.admitted_step, j.stall)
                 for j in jobs},
        "report": sched.report(), "tenant_report": sched.tenant_report(),
        "stall_ledger": sched.stall_ledger(), "now": sched.now,
        "tenant_metrics": sched.tenant_metrics,
        "kv_stall": sched.engine.kv_stall_time,
        "clock": sched.engine.clock.now(),
    }


def _prompt(rng, n, vocab):
    return rng.integers(1, vocab, n).astype(np.int32)


# ---------------------------------------------------------------------------
# the workload generator and the continuous-vs-lockstep race
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scenario", SCENARIOS)
def test_jobs_from_trace_equal_reference(scenario):
    kw = dict(n_jobs=5, n_turns=2, tokens_per_turn=4, vocab=256,
              horizon=48, seed=3)

    def fingerprint(S):
        return [(j.sid, j.tenant, j.prompt.tobytes(),
                 [dataclasses.astuple(t) for t in j.turns])
                for j in S.jobs_from_trace(scenario, **kw)]
    assert fingerprint(TS) == fingerprint(JS)
    with pytest.raises(ValueError, match="unknown scenario"):
        TS.jobs_from_trace("nope")


@pytest.mark.parametrize("scenario,seed", [("zipf", 0),
                                           ("multi_tenant", 3)])
def test_compare_scheduling_matches_reference(sides, scenario, seed):
    """Reference `test_continuous_matches_lockstep_on_trace_jobs` and
    `test_declared_multi_tenant_jobs_token_equivalence`: both arms'
    reports, the verdicts and every session's tokens per arm."""
    def run(side):
        made = []

        def jobs():
            made.append(side.S.jobs_from_trace(
                scenario, n_jobs=5, n_turns=2, tokens_per_turn=4,
                vocab=side.vocab, horizon=48, seed=seed))
            return made[-1]
        cell = side.S.compare_scheduling(
            lambda: side.engine(max_slots=3, max_len=MAX_LEN,
                                store=side.Store(_pinned_flash(side),
                                                 clock=side.Clock()),
                                step_time=2e-3),
            jobs, pause_idle_steps=4)
        return {"cell": cell, "tokens": [
            {j.sid: list(j.request.generated) for j in arm}
            for arm in made]}
    got = _both(sides, run)
    cell = got["cell"]
    assert cell["tokens_identical"], cell["token_mismatches"]
    assert got["tokens"][0] == got["tokens"][1]
    assert cell["continuous"]["tokens"] == cell["lockstep"]["tokens"]
    if scenario == "zipf":
        assert cell["continuous_wins"], (cell["throughput_ratio"],
                                         cell["stall_ratio"])
    else:
        tenants = cell["continuous"]["tenants"]
        assert set(tenants) == {"tenant_a", "tenant_b"}
        assert sum(d["tokens"] for d in tenants.values()) \
            == cell["continuous"]["tokens"]


# ---------------------------------------------------------------------------
# scheduler scenarios
# ---------------------------------------------------------------------------

def test_scheduler_parks_short_gaps_and_preempts_for_admissions(sides):
    def run(side):
        rng = np.random.default_rng(14)
        eng = _engine(side, max_slots=1)
        sched = side.S.ContinuousScheduler(eng, pause_idle_steps=8,
                                           prefetch_lead=0)
        jobs = _jobs(side, [
            ("x", _prompt(rng, 5, side.vocab), [(0, 3, 0), (9, 3, 0)], ""),
            ("y", _prompt(rng, 4, side.vocab), [(4, 3, 0)], "")])
        sched.run(jobs, max_ticks=200)
        return _outcome(sched, jobs)
    got = _both(sides, run)
    rep = got["report"]
    assert got["jobs"]["x"][0] == got["jobs"]["y"][0] == "done"
    assert rep["parks"] >= 1 and rep["preempt_pauses"] >= 1
    assert rep["resumes"] >= 1
    assert len(got["tokens"]["x"]) == 6 and len(got["tokens"]["y"]) == 3


def test_platform_scheduler_uses_spec_knobs(sides):
    spec = JP.HierarchySpec(policy=JP.PolicyDecl.pinned_flash(),
                            step_time=2e-3,
                            scheduler=JP.SchedulerDecl(pause_idle_steps=3,
                                                       prefetch_lead=2))

    def run(side):
        plat = side.compile(spec)
        s1 = side.scheduler(plat, max_slots=2, max_len=MAX_LEN)
        s2 = side.scheduler(plat, pause_idle_steps=0, prefetch_lead="p99",
                            max_slots=2, max_len=MAX_LEN)
        return [(s.pause_idle_steps, s.prefetch_lead, s.engine.step_time,
                 s.engine.max_slots, s.stall_budgets) for s in (s1, s2)]
    got = _both(sides, run)
    assert got == [(3, 2, 2e-3, 2, {}), (0, "p99", 2e-3, 2, {})]
    _, port = sides
    sched = port.scheduler(port.compile(spec), max_slots=2,
                           max_len=MAX_LEN)
    assert isinstance(sched, TS.ContinuousScheduler)
    assert sched.engine.device.type == "cpu"


def test_scheduler_decl_validation_matches_reference():
    for P in (TP, JP):
        spec = P.HierarchySpec(scheduler=P.SchedulerDecl(
            pause_idle_steps=4, prefetch_lead=2))
        assert P.HierarchySpec.from_json(spec.to_json()) == spec
    assert TP.HierarchySpec(scheduler=TP.SchedulerDecl(
        pause_idle_steps=4, prefetch_lead=2)).to_json() \
        == JP.HierarchySpec(scheduler=JP.SchedulerDecl(
            pause_idle_steps=4, prefetch_lead=2)).to_json()
    for kw, match in ((dict(pause_idle_steps=-1), "pause_idle_steps"),
                      (dict(prefetch_lead="p50"), "prefetch_lead")):
        msgs = []
        for P in (TP, JP):
            with pytest.raises(ValueError, match=match) as err:
                P.HierarchySpec(scheduler=P.SchedulerDecl(**kw)).validate()
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1]


def _draw_jobs(rng, vocab):
    """The reference property test's job draw, as plain data."""
    specs = []
    for i in range(int(rng.integers(2, 5))):
        prompt = rng.integers(1, vocab, 5).astype(np.int32)
        turns, prev = [], int(rng.integers(0, 6)) - 1
        for _ in range(int(rng.integers(1, 4))):
            new = int(rng.integers(2, 7))
            due = prev + new + int(rng.integers(1, 7))
            turns.append((due, new, int(rng.integers(0, 5))))
            prev = due
        specs.append((f"s{i}", prompt, turns, ""))
    return specs


@settings(max_examples=4, deadline=None)
@given(st.integers(min_value=0, max_value=1_000_000))
def test_scheduler_interleaving_property(sides, seed):
    """The reference's property (`test_scheduler_interleaving_property`):
    random multi-turn jobs under random knobs, with an unplanned host
    failure mid-run (replicas=2) on the continuous arm; every job
    completes with the lock-step arm's tokens. Both packages run the
    same draw, and the port's continuous arm must equal the
    reference's."""
    rng = np.random.default_rng(seed)
    specs = _draw_jobs(rng, sides[1].vocab)
    pause_idle = int(rng.integers(0, 7))
    lead = ["p99", 0, 2][int(rng.integers(0, 3))]
    do_fail = bool(rng.integers(0, 2))
    fail_tick = int(rng.integers(2, 16))

    def run(side):
        fabric = side.Fabric(2, clock=side.Clock())
        eng = side.engine(max_slots=3, max_len=MAX_LEN, step_time=2e-3,
                          store=fabric.host_view(0, replicas=2))
        sched = side.S.ContinuousScheduler(eng, pause_idle_steps=pause_idle,
                                           prefetch_lead=lead)
        cont = _jobs(side, specs)
        sched.submit_all(cont)
        failed = False
        while sched.pending_work() and sched.metrics["ticks"] < 600:
            if do_fail and not failed and \
                    sched.metrics["ticks"] == fail_tick:
                fabric.fail_host(1)
                failed = True
            sched.tick()
        lock = _jobs(side, specs)
        lock_rep = side.S.run_lockstep(
            _engine(side, max_slots=3,
                    store=side.Store(_pinned_flash(side),
                                     clock=side.Clock())),
            lock, max_ticks=600)
        return {"cont": _outcome(sched, cont), "lock": lock_rep,
                "lock_tokens": {j.sid: list(j.request.generated)
                                for j in lock},
                "pending": sched.pending_work(),
                "summary": fabric.summary()}
    got = _both(sides, run)
    assert not got["pending"]
    assert got["cont"]["tokens"] == got["lock_tokens"]
    for sid, _, turns, _ in specs:
        assert got["cont"]["jobs"][sid][0] == "done"
        assert len(got["cont"]["tokens"][sid]) == sum(n for _, n, _ in
                                                      turns)


def test_unpark_is_counted_and_deadline_checked(sides):
    def run(side):
        rng = np.random.default_rng(21)
        out = {}
        # on-time unpark: counted (fleet + tenant), no miss
        sched = side.S.ContinuousScheduler(
            _engine(side, max_slots=2), pause_idle_steps=8,
            prefetch_lead=0)
        x = _jobs(side, [("x", _prompt(rng, 5, side.vocab),
                          [(0, 3, 0), (9, 3, 4)], "t")])
        sched.run(x, max_ticks=200)
        out["on_time"] = _outcome(sched, x)
        # late unpark: a parked turn popped past its deadline is a miss
        sched2 = side.S.ContinuousScheduler(
            _engine(side, max_slots=2), pause_idle_steps=8,
            prefetch_lead=0)
        y = _jobs(side, [("y", _prompt(rng, 5, side.vocab),
                          [(0, 3, 0), (9, 3, 4)], "t")])
        sched2.submit(y[0])
        for _ in range(50):
            sched2.tick()
            if y[0].state == "parked":
                break
        out["parked"] = y[0].state
        sched2.now = y[0].deadline() + 5
        sched2.tick()
        out["late"] = _outcome(sched2, y)
        return out
    got = _both(sides, run)
    rep = got["on_time"]["report"]
    assert rep["parks"] >= 1 and rep["unparks"] == rep["parks"]
    assert rep["deadline_misses"] == 0
    assert rep["tenants"]["t"]["unparks"] == rep["unparks"]
    assert got["parked"] == "parked"
    late = got["late"]
    assert late["jobs"]["y"][0] == "running"
    assert late["report"]["unparks"] == 1
    assert late["report"]["deadline_misses"] == 1
    assert late["tenant_metrics"]["t"]["deadline_misses"] == 1


# ---------------------------------------------------------------------------
# tenant_report edge cases (reference tests/test_tenant_report.py)
# ---------------------------------------------------------------------------

CELL_KEYS = {"sessions", "tokens", "stall", "per_token_stall",
             "p99_per_token_stall", "admissions", "resumes", "unparks",
             "parks", "pauses", "deadline_misses", "ledger_stall"}
PROMPT = np.arange(1, 5, dtype=np.int32)


def _report_scheduler(side, *, pause_idle_steps=0, stall_budgets=None):
    clock = side.Clock()
    store = side.Store(_pinned_flash(side), clock=clock)
    eng = side.engine(max_slots=2, max_len=MAX_LEN, store=store,
                      clock=clock, step_time=0.25)
    return side.S.ContinuousScheduler(eng, pause_idle_steps=pause_idle_steps,
                                      prefetch_lead=0,
                                      stall_budgets=stall_budgets)


def test_zero_admitted_tenant_reports_uniform_zero_cell(sides):
    def run(side):
        sched = _report_scheduler(side)
        jobs = _jobs(side, [("fast/000", PROMPT, [(0, 3, 0)], "fast"),
                            ("late/000", PROMPT, [(10_000, 3, 0)], "late"),
                            ("late/001", PROMPT, [(10_000, 3, 0)], "late")])
        sched.submit_all(jobs)
        while sched.metrics["ticks"] < 12:
            sched.tick()
        return _outcome(sched, jobs)
    report = _both(sides, run)["report"]
    cell = report["tenants"]["late"]
    assert set(cell) == CELL_KEYS and cell["sessions"] == 2
    assert cell["tokens"] == 0 and cell["stall"] == 0.0
    assert cell["p99_per_token_stall"] == 0.0 and cell["admissions"] == 0
    assert set(report["tenants"]["fast"]) == CELL_KEYS
    assert report["tenants"]["fast"]["admissions"] == 1


def test_unpark_only_tenant_has_no_restore_stall(sides):
    def run(side):
        sched = _report_scheduler(side, pause_idle_steps=8)
        jobs = _jobs(side, [("parky/000", PROMPT, [(0, 3, 0), (8, 3, 4)],
                             "parky")])
        sched.run(jobs)
        return {"out": _outcome(sched, jobs),
                "ledger_tenants": sorted(sched.ledger.tenants)}
    got = _both(sides, run)
    cell = got["out"]["report"]["tenants"]["parky"]
    assert set(cell) == CELL_KEYS
    assert cell["parks"] >= 1 and cell["unparks"] >= 1
    assert cell["pauses"] == 0 and cell["resumes"] == 0
    assert cell["stall"] == 0.0 and cell["tokens"] == 6
    assert "parky" not in got["ledger_tenants"]


def test_tenant_report_stable_across_store_reset_stats(sides):
    def run(side):
        sched = _report_scheduler(side)
        jobs = _jobs(side, [("a/000", PROMPT, [(0, 3, 0), (6, 3, 0)], "a"),
                            ("b/000", PROMPT, [(1, 3, 0)], "b")])
        sched.run(jobs)
        before = _outcome(sched, jobs)
        sched.engine.store.reset_stats()
        return before, _outcome(sched, jobs)
    before, after = _both(sides, run)
    assert after["tenant_report"] == before["tenant_report"]
    assert after["stall_ledger"] == before["stall_ledger"]


def test_budget_burn_emitted_only_for_budgeted_tenants(sides):
    def run(side):
        sched = _report_scheduler(side, stall_budgets={"prem": 1e-6})
        jobs = _jobs(side, [
            ("prem/000", PROMPT, [(0, 3, 0), (8, 3, 0)], "prem"),
            ("bulk/000", PROMPT, [(0, 3, 0), (8, 3, 0)], "bulk")])
        sched.run(jobs)
        return {"out": _outcome(sched, jobs),
                "prem_ledger": sched._tenant_ledger("prem")}
    got = _both(sides, run)
    tenants = got["out"]["report"]["tenants"]
    assert "budget_burn" in tenants["prem"]
    assert np.isfinite(tenants["prem"]["budget_burn"])
    assert tenants["prem"]["ledger_stall"] == pytest.approx(
        sum(got["prem_ledger"].values()))
    assert "budget_burn" not in tenants["bulk"]
    assert "ledger_stall" in tenants["bulk"]


def test_paused_kv_blob_matches_reference_blob_bytes(sides):
    """The reference pins the paused blob's bytes (its tenant pack prices
    DRAM in blob units); the port's blob must have the same byte count,
    and the tiers see that count."""
    def run(side):
        eng = _engine(side, max_slots=3,
                      store=side.Store(_pinned_flash(side),
                                       clock=side.Clock()))
        eng.admit(side.Request(rid="probe",
                               prompt=np.arange(1, 6, dtype=np.int32),
                               max_new=8))
        eng.step()
        eng.pause("probe")
        blob = eng.store.get(("kv", "probe"))
        return sum(np.asarray(x).nbytes for x in
                   jax.tree_util.tree_leaves(blob)), \
            eng.store.nbytes_of(("kv", "probe"))
    nbytes, stored = _both(sides, run)
    assert nbytes == stored > 0


# ---------------------------------------------------------------------------
# the slice: HierarchySpec -> Platform.compile -> Platform.scheduler ->
# run(Platform.jobs())
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("isolation", ["per-tenant", "shared"])
def test_platform_scheduler_serves_declared_workload_like_reference(
        sides, isolation):
    _declared_workload_matches_reference(sides, isolation)


def _declared_workload_matches_reference(sides, isolation):
    """The reference tests' tenant pack through Platform.compile ->
    Platform.scheduler -> run(Platform.jobs()) on both sides: outcome,
    trace, ledger, summary, tau_be and the sessions the scheduler parked
    equal, and the pack's invariants.

    A config with recurrent state (zamba2-7b, xlstm-350m) differs in one
    place: the reference's decode step advances a parked slot's recurrent
    state on its stale token, so a session it parked decodes other tokens after the
    unpark; the port keeps a parked slot's state. There every session's
    tokens but the parked ones' equal the reference's, and the parked
    sessions' tokens equal the port's own `run_lockstep` (which never
    parks) on the same jobs."""
    spec = JP.HierarchySpec(
        policy=JP.PolicyDecl.economic(l_blk=64 << 10), step_time=2e-3,
        scheduler=JP.SchedulerDecl(pause_idle_steps=4, prefetch_lead="p99"),
        observability=JP.ObservabilityDecl(trace=True),
        workload=_pack_decl(isolation=isolation))

    def run(side):
        plat = side.compile(spec)
        sched = side.scheduler(plat, max_slots=3, max_len=MAX_LEN)
        parked = set()
        park = sched.engine.park
        sched.engine.park = lambda sid: (parked.add(sid), park(sid))[1]
        jobs = plat.jobs(vocab=side.vocab)
        sched.run(jobs)
        return {"out": _outcome(sched, jobs),
                "trace": plat.tracer.to_chrome_json(),
                "ledger": plat.ledger.as_dict(),
                "summary": plat.summary(),
                "tau": plat.policy(0).class_tau_be,
                "parked": sorted(parked)}
    ref, port = sides
    want, got = run(ref), run(port)
    if port.recurrent:
        assert got["parked"] == want["parked"] and got["parked"]
        jobs = port.compile(spec).jobs(vocab=port.vocab)
        TS.run_lockstep(port.engine(max_slots=3, max_len=MAX_LEN), jobs)
        lockstep = {j.sid: list(j.request.generated) for j in jobs}
        for sid in got["parked"]:
            want["out"]["tokens"][sid] = lockstep[sid]
    _close(got, want)
    # the Perfetto export (scheduler instants among the engine's and the
    # runtime's events) is byte for byte the reference's
    assert '"scheduler"' in got["trace"] and "policy" in got["trace"]
    m = got["out"]["report"]
    assert m["tokens"] == sum(
        sum(t.max_new for t in j.turns) for j in
        port.compile(spec).jobs(vocab=port.vocab))
    assert m["pauses"] > 0 and m["resumes"] > 0
    assert "budget_burn" in m["tenants"]["premium"]
    assert all("budget_burn" not in m["tenants"][t] for t in ("rag", "scan"))
    # Eq. 1 conservation, as the reference's isolation test holds it
    led = m["stall_ledger"]
    rhs = m["kv_stall"] + 2e-3 * m["slot_idle_steps"]
    assert abs(led["total"] - rhs) <= 1e-9 * max(rhs, 1e-30)
    assert sum(c["ledger_stall"] for c in m["tenants"].values()) \
        <= led["total"] - led["scheduler_idle"] + 1e-12
    if isolation == "per-tenant":
        assert got["tau"]["premium"] > got["tau"]["scan"]
    else:
        assert got["tau"] is None
