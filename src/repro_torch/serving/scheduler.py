"""Continuous batching scheduler: per-step admission over the slot grid.

The seed `DecodeEngine.run` loop is all-or-nothing gang scheduling: a
batch is admitted, decoded until *every* member finishes, and only then
are new requests admitted — a slot going idle stalls the rest of the
batch for the whole gang tail. `ContinuousScheduler` replaces it with a
step-level control loop over the same engine: every tick it

  1. moves newly due session turns into an EDF-ordered admission queue
     (earliest absolute deadline = `due_step + deadline_steps` first),
  2. issues prefetch-led restores for paused sessions whose next turn
     is within the p99-sized prefetch lead,
  3. fills every free slot from the queue (first turns via the bucketed
     prefill + slot splice, later turns via `resume`; eager torch
     traces no programs, so per-step admission compiles nothing),
  4. runs one decode step (or advances the clock when the grid is idle),
  5. pauses-on-idle at turn boundaries: a session whose next turn is
     further than `pause_idle_steps` away is offloaded through the
     tiered store (the paper's five-minute-rule decision point — the
     policy picks DRAM vs flash from tracked reuse); shorter gaps park
     in place (slot held, no decode, no restore stall). Parked slots
     are preempted (paused) when the queue needs their slot.

Time is discrete: one tick == one decode step == `engine.step_time`
modeled seconds, and `Turn.due_step` is an absolute tick index. All
state transitions are deterministic given the job list, so token output
is byte-identical to the lock-step reference (`run_lockstep`) — greedy
decode makes the tokens a function of the prompt alone, and the
property tests assert the schedulers cannot change them.

Scheduling waste is first-class: `slot_idle_steps` counts slot-ticks
where a slot could have decoded but didn't (free or parked) while work
existed in the system. The comparison metric
`per_token_stall = (kv_stall + step_time * slot_idle_steps) / tokens`
charges gang idling and restore stalls in the same currency, which is
what makes continuous-vs-lockstep an apples-to-apples race
(`compare_scheduling`).
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional

import numpy as np

from ..obs.ledger import COMPONENTS, StallLedger
from .engine import DecodeEngine, Request


@dataclasses.dataclass(frozen=True)
class Turn:
    """One session turn: becomes runnable at absolute tick `due_step`,
    generates `max_new` tokens, and should be admitted within
    `deadline_steps` ticks of becoming due (0 = as soon as possible;
    the EDF queue orders by `due_step + deadline_steps`)."""
    due_step: int
    max_new: int
    deadline_steps: int = 0


# eq=False for the same reason as Request: the ndarray prompt poisons
# the generated __eq__, and jobs are keyed by sid everywhere
@dataclasses.dataclass(eq=False)
class SessionJob:
    sid: str
    prompt: np.ndarray                  # [S] int32, first-turn prefill
    turns: List[Turn]
    tenant: str = ""                    # SLO accounting class ("" = none)
    # runtime state (owned by the scheduler)
    request: Optional[Request] = None
    turn_idx: int = 0
    state: str = "waiting"  # waiting|ready|running|parked|paused|done
    admitted_step: int = -1
    stall: float = 0.0      # restore (KV fetch) stall attributed here (s)

    def target(self) -> int:
        """Cumulative token count at the end of the current turn."""
        return sum(t.max_new for t in self.turns[:self.turn_idx + 1])

    def total(self) -> int:
        return sum(t.max_new for t in self.turns)

    def due(self) -> int:
        return self.turns[self.turn_idx].due_step

    def deadline(self) -> int:
        t = self.turns[self.turn_idx]
        return t.due_step + t.deadline_steps


class ContinuousScheduler:
    """Step-level admission/eviction controller over one `DecodeEngine`.

    Knobs (also declarable via `HierarchySpec.scheduler`):
      pause_idle_steps: inter-turn gaps <= this many ticks keep the
        session parked in its slot; longer gaps offload through the
        tiered store (0 = always offload).
      prefetch_lead: "p99" sizes each paused session's restore prefetch
        from the serving tier's calibrated tail (`engine.prefetch_lead`);
        an int is a fixed lead in ticks; 0 disables prefetch.
    """

    def __init__(self, engine: DecodeEngine, *,
                 pause_idle_steps: int = 0,
                 prefetch_lead="p99",
                 stall_budgets: Optional[Dict[str, float]] = None):
        self.engine = engine
        self.pause_idle_steps = int(pause_idle_steps)
        self.prefetch_lead = prefetch_lead
        self.obs = getattr(engine, "obs", None)
        # adopt the store's always-on stall ledger (TieredStore and the
        # fabric's HostView both expose one); idle-slot rent lands there
        # under the identical condition `slot_idle_steps` counts, which
        # is what makes the conservation law in report() exact
        ledger = getattr(engine.store, "ledger", None)
        self.ledger = ledger if ledger is not None else StallLedger()
        self._ledger_base = self.ledger.snapshot()
        self._ledger_tenant_base = {
            t: dict(v) for t, v in self.ledger.tenants.items()}
        # tenant -> declared p99 stall budget (sec/token); report()
        # derives each tenant's budget burn from its ledger slice
        self.stall_budgets = dict(stall_budgets) if stall_budgets else {}
        self.now = 0                    # tick index (== decode steps + idle)
        self.jobs: Dict[str, SessionJob] = {}
        self._waiting: List[tuple] = []  # heap of (due, seq, job)
        self._ready: List[tuple] = []    # heap of (deadline, due, seq, job)
        self._seq = 0                    # FIFO tie-break, deterministic
        self.metrics = {
            "ticks": 0, "decode_steps": 0, "idle_ticks": 0,
            "slot_idle_steps": 0, "parked_slot_steps": 0,
            "admissions": 0, "resumes": 0, "unparks": 0, "pauses": 0,
            "parks": 0, "preempt_pauses": 0, "prefetches": 0,
            "deadline_misses": 0, "tokens": 0,
        }
        # per-tenant event counters (report() folds in token/stall sums)
        self.tenant_metrics: Dict[str, Dict[str, int]] = {}

    # ------------------------------------------------------------- intake
    def submit(self, job: SessionJob):
        if not job.turns:
            raise ValueError(f"job {job.sid!r} has no turns")
        if job.sid in self.jobs:
            raise KeyError(f"job {job.sid!r} already submitted")
        self.jobs[job.sid] = job
        job.state = "waiting"
        self._push_waiting(job)

    def submit_all(self, jobs):
        for j in jobs:
            self.submit(j)

    def _push_waiting(self, job: SessionJob):
        heapq.heappush(self._waiting, (job.due(), self._seq, job))
        self._seq += 1

    def _push_ready(self, job: SessionJob):
        job.state = "ready"
        heapq.heappush(self._ready,
                       (job.deadline(), job.due(), self._seq, job))
        self._seq += 1

    # ------------------------------------------------------------ queries
    def pending_work(self) -> bool:
        return any(j.state != "done" for j in self.jobs.values())

    def _lead_for(self, job: SessionJob) -> int:
        if self.prefetch_lead == "p99":
            return self.engine.prefetch_lead(job.sid)
        return int(self.prefetch_lead)

    def _bump(self, job: SessionJob, field: str, by: int = 1):
        """Count `field` against the job's tenant (no-op untagged)."""
        if not job.tenant:
            return
        m = self.tenant_metrics.get(job.tenant)
        if m is None:
            m = {"admissions": 0, "resumes": 0, "unparks": 0,
                 "parks": 0, "pauses": 0, "deadline_misses": 0}
            self.tenant_metrics[job.tenant] = m
        m[field] += by

    def _trace(self, name: str, **args):
        """Scheduler policy instant on the modeled clock (no-op unless
        an `Observability` with tracing is attached to the engine)."""
        obs = self.obs
        if obs is None or obs.tracer is None:
            return
        t = obs.tracer
        args["tick"] = self.now
        t.instant(t.track("scheduler", "policy"), name,
                  self.engine.clock.now(), cat="policy", args=args)

    # --------------------------------------------------------------- tick
    def tick(self):
        """One scheduler step: arrivals -> prefetch -> admission ->
        decode (or idle clock advance) -> turn boundaries."""
        eng = self.engine
        # 1. arrivals: due turns leave the waiting heap
        while self._waiting and self._waiting[0][0] <= self.now:
            _, _, job = heapq.heappop(self._waiting)
            if job.state == "parked":
                # resident the whole gap: just flip the slot back on.
                # This is an admission like any other — counted, and
                # held to the same deadline check paused sessions pay
                # (a parked turn popped late is still a miss)
                eng.unpark(job.sid)
                job.state = "running"
                job.admitted_step = self.now
                self.metrics["unparks"] += 1
                self._bump(job, "unparks")
                if self.now > job.deadline():
                    self.metrics["deadline_misses"] += 1
                    self._bump(job, "deadline_misses")
                    self._trace("deadline_miss", sid=job.sid,
                                deadline=job.deadline())
            else:
                self._push_ready(job)
        # 2. prefetch-led resume for paused sessions nearing their due
        for job in self._paused_jobs():
            lead = self._lead_for(job)
            if lead > 0 and job.due() - self.now <= lead:
                if job.sid not in eng._pending:
                    eng.prefetch(job.sid)
                    self.metrics["prefetches"] += 1
        # 3. admission: fill free slots in EDF order; parked slots are
        # preempted (offloaded) when the queue is hungry and the grid
        # is full
        while self._ready:
            if not eng._free_slots() and not self._preempt_parked():
                break
            _, _, _, job = heapq.heappop(self._ready)
            self._admit(job)
        # 4. decode or idle tick
        decoding = int((eng.live & eng.active).sum())
        if decoding:
            eng.step()
            self.metrics["decode_steps"] += 1
        else:
            if eng.step_time:
                eng.store.runtime.advance(eng.step_time)
            self.metrics["idle_ticks"] += 1
        if self.pending_work():
            idle_slots = eng.max_slots - decoding
            self.metrics["slot_idle_steps"] += idle_slots
            self.metrics["parked_slot_steps"] += int(
                (eng.live & ~eng.active).sum())
            if idle_slots and eng.step_time:
                self.ledger.add("scheduler_idle",
                                eng.step_time * idle_slots)
        self.metrics["ticks"] += 1
        self.now += 1
        # 5. turn boundaries: pause-on-idle / park / retire
        if decoding:
            self._turn_boundaries()

    def _paused_jobs(self):
        # sid-sorted for deterministic prefetch issue order
        return sorted((j for j in self.jobs.values()
                       if j.state == "paused"), key=lambda j: j.sid)

    def _preempt_parked(self) -> bool:
        """Offload the parked session whose next turn is furthest away;
        True when a slot was freed for the admission queue."""
        parked = [j for j in self.jobs.values() if j.state == "parked"]
        if not parked:
            return False
        victim = max(parked, key=lambda j: (j.due(), j.sid))
        self.engine.pause(victim.sid)
        victim.state = "paused"
        self.metrics["pauses"] += 1
        self.metrics["preempt_pauses"] += 1
        self._bump(victim, "pauses")
        self._trace("preempt_pause", sid=victim.sid, due=victim.due())
        return True

    def _admit(self, job: SessionJob):
        eng = self.engine
        if job.request is None:
            job.request = Request(job.sid, job.prompt,
                                  max_new=job.total())
            eng.admit(job.request)
            self.metrics["admissions"] += 1
            self._bump(job, "admissions")
        else:
            # the engine's stall clock advances inside resume (waiting
            # out the KV fetch); the delta is this session's restore
            # stall — the per-tenant p99 currency
            before = eng.kv_stall_time
            eng.resume(job.sid)
            job.stall += eng.kv_stall_time - before
            self.metrics["resumes"] += 1
            self._bump(job, "resumes")
        job.state = "running"
        job.admitted_step = self.now
        if self.now > job.deadline():
            self.metrics["deadline_misses"] += 1
            self._bump(job, "deadline_misses")
            self._trace("deadline_miss", sid=job.sid,
                        deadline=job.deadline())

    def _turn_boundaries(self):
        eng = self.engine
        for job in sorted(self.jobs.values(), key=lambda j: j.sid):
            if job.state != "running":
                continue
            req = job.request
            if req.done:
                job.state = "done"
                continue
            if len(req.generated) < job.target():
                continue
            # intermediate turn boundary: park short gaps, offload long
            job.turn_idx += 1
            gap = job.due() - self.now
            if 0 < gap <= self.pause_idle_steps:
                eng.park(job.sid)
                job.state = "parked"
                self.metrics["parks"] += 1
                self._bump(job, "parks")
                self._push_waiting(job)
            elif gap <= 0:
                # next turn already due: keep decoding in place
                pass
            else:
                eng.pause(job.sid)
                job.state = "paused"
                self.metrics["pauses"] += 1
                self._bump(job, "pauses")
                self._push_waiting(job)

    # ---------------------------------------------------------------- run
    def run(self, jobs: Optional[List[SessionJob]] = None, *,
            max_ticks: int = 100_000) -> Dict[str, float]:
        if jobs:
            self.submit_all(jobs)
        while self.pending_work() and self.metrics["ticks"] < max_ticks:
            self.tick()
        return self.report()

    def report(self) -> Dict[str, float]:
        eng = self.engine
        m = dict(self.metrics)
        tokens = sum(len(j.request.generated)
                     for j in self.jobs.values() if j.request is not None)
        m["tokens"] = tokens
        m["kv_stall"] = eng.kv_stall_time
        m["makespan"] = m["ticks"] * eng.step_time
        m["tokens_per_sec"] = (tokens / m["makespan"]
                               if m["makespan"] > 0 else 0.0)
        idle_cost = eng.step_time * m["slot_idle_steps"]
        m["per_token_stall"] = ((eng.kv_stall_time + idle_cost)
                                / max(tokens, 1))
        m["stall_ledger"] = self.stall_ledger()
        tenants = self.tenant_report()
        if tenants:
            for name, cell in tenants.items():
                tled = self._tenant_ledger(name)
                cell["ledger_stall"] = sum(tled.values())
                budget = self.stall_budgets.get(name)
                if budget:
                    # burn rate of the declared SLO budget: ledger
                    # seconds spent / (budget sec-per-token * tokens);
                    # > 1.0 means the tenant's stall budget is blown
                    cell["budget_burn"] = (
                        cell["ledger_stall"]
                        / (budget * max(cell["tokens"], 1)))
            m["tenants"] = tenants
        return m

    # ------------------------------------------------------- stall ledger
    def stall_ledger(self) -> Dict[str, float]:
        """Eq. 1 decomposition of this run's stalled seconds (delta
        since construction, so a shared fleet ledger reports only this
        scheduler's slice). Conservation law, enforced by tests:
        `total == kv_stall + step_time * slot_idle_steps` to 1e-9."""
        led = self.ledger.delta_since(self._ledger_base)
        led["total"] = sum(led[c] for c in COMPONENTS)
        return led

    def _tenant_ledger(self, tenant: str) -> Dict[str, float]:
        cur = self.ledger.tenants.get(tenant, {})
        base = self._ledger_tenant_base.get(tenant, {})
        return {c: cur.get(c, 0.0) - base.get(c, 0.0)
                for c in COMPONENTS}

    def tenant_report(self) -> Dict[str, Dict[str, float]]:
        """Per-tenant SLO accounting over tagged jobs: token/stall
        sums, mean and p99 per-token restore stall (p99 across the
        tenant's sessions — each session's sample is its own
        stall/tokens), plus the event counters. Slot-idle rent is a
        fleet-level cost and stays out of the per-tenant stall."""
        out: Dict[str, Dict[str, float]] = {}
        samples: Dict[str, List[float]] = {}
        for job in sorted(self.jobs.values(), key=lambda j: j.sid):
            if not job.tenant:
                continue
            d = out.setdefault(job.tenant, {
                "sessions": 0, "tokens": 0, "stall": 0.0})
            tokens = (len(job.request.generated)
                      if job.request is not None else 0)
            d["sessions"] += 1
            d["tokens"] += tokens
            d["stall"] += job.stall
            samples.setdefault(job.tenant, []).append(
                job.stall / max(tokens, 1))
        for name, d in out.items():
            d["per_token_stall"] = d["stall"] / max(d["tokens"], 1)
            d["p99_per_token_stall"] = float(
                np.percentile(np.array(samples[name]), 99))
            # uniform cells: a tenant that never hit an event path (or
            # was never admitted at all) still reports zeroed counters,
            # so downstream JSON diffs compare keys, not key *sets*
            for k in ("admissions", "resumes", "unparks", "parks",
                      "pauses", "deadline_misses"):
                d[k] = self.tenant_metrics.get(name, {}).get(k, 0)
        return {k: out[k] for k in sorted(out)}


def run_lockstep(engine: DecodeEngine, jobs: List[SessionJob], *,
                 max_ticks: int = 100_000) -> Dict[str, float]:
    """All-or-nothing gang reference (the seed `run()` discipline, made
    turn-aware): admit a gang of due turns, decode until *every* gang
    member's turn completes (finished slots sit empty — no mid-gang
    admission), pause members with later turns, repeat. Idle-slot and
    stall accounting use the same definitions as the continuous
    scheduler, so the two reports are directly comparable."""
    jobs = list(jobs)
    for job in jobs:
        job.state = "waiting"
    now = 0
    metrics = {
        "ticks": 0, "decode_steps": 0, "idle_ticks": 0,
        "slot_idle_steps": 0, "parked_slot_steps": 0,
        "admissions": 0, "resumes": 0, "unparks": 0, "pauses": 0,
        "parks": 0, "preempt_pauses": 0, "prefetches": 0,
        "deadline_misses": 0,
    }

    def pending_work():
        return any(j.state != "done" for j in jobs)

    def tick_idle():
        nonlocal now
        if engine.step_time:
            engine.store.runtime.advance(engine.step_time)
        metrics["idle_ticks"] += 1
        metrics["ticks"] += 1
        if pending_work():
            metrics["slot_idle_steps"] += engine.max_slots
        now += 1

    while pending_work() and metrics["ticks"] < max_ticks:
        ready = sorted((j for j in jobs
                        if j.state in ("waiting", "paused")
                        and j.due() <= now),
                       key=lambda j: (j.deadline(), j.due(), j.sid))
        if not ready:
            tick_idle()
            continue
        gang: List[SessionJob] = []
        for job in ready:
            if not engine._free_slots():
                break
            if job.request is None:
                job.request = Request(job.sid, job.prompt,
                                      max_new=job.total())
                engine.admit(job.request)
                metrics["admissions"] += 1
            else:
                before = engine.kv_stall_time
                engine.resume(job.sid)
                job.stall += engine.kv_stall_time - before
                metrics["resumes"] += 1
            if now > job.deadline():
                metrics["deadline_misses"] += 1
            job.state = "running"
            job.admitted_step = now
            gang.append(job)
        # decode until the whole gang's turns complete — the lock-step
        # waste this module exists to remove
        while any(j.state == "running" for j in gang):
            decoding = int((engine.live & engine.active).sum())
            engine.step()
            metrics["decode_steps"] += 1
            metrics["ticks"] += 1
            metrics["slot_idle_steps"] += engine.max_slots - decoding
            now += 1
            for job in gang:
                if job.state != "running":
                    continue
                if job.request.done:
                    job.state = "done"
                elif len(job.request.generated) >= job.target():
                    job.turn_idx += 1
                    if job.due() <= now:
                        continue    # next turn already due: keep going
                    engine.pause(job.sid)
                    job.state = "paused"
                    metrics["pauses"] += 1

    tokens = sum(len(j.request.generated) for j in jobs
                 if j.request is not None)
    m = dict(metrics)
    m["tokens"] = tokens
    m["kv_stall"] = engine.kv_stall_time
    m["makespan"] = m["ticks"] * engine.step_time
    m["tokens_per_sec"] = (tokens / m["makespan"]
                           if m["makespan"] > 0 else 0.0)
    idle_cost = engine.step_time * m["slot_idle_steps"]
    m["per_token_stall"] = ((engine.kv_stall_time + idle_cost)
                            / max(tokens, 1))
    return m


def jobs_from_trace(scenario: str, *, n_jobs: int = 8,
                    n_turns: int = 3, tokens_per_turn: int = 6,
                    prompt_len: int = 5, vocab: int = 64,
                    horizon: int = 96, seed: int = 0
                    ) -> List[SessionJob]:
    """Deterministic multi-turn job set for an autopilot trace scenario,
    rendered through the `WorkloadDecl` compiler: the scenario name maps
    to a declared arrival process (zipf -> stationary, scan_flood ->
    periodic bursts, diurnal -> the day curve, multi_tenant -> a steady
    + a bursty tenant), so the continuous-vs-lockstep race runs on the
    same declared shapes the economics benches and the tenant-isolation
    bench use."""
    from ..autopilot.traces import SCENARIOS
    from ..platform.spec import (ArrivalDecl, SessionShapeDecl, SloDecl,
                                 TenantDecl, WorkloadDecl)
    from ..platform.workload import compile_workload
    if scenario not in SCENARIOS:
        raise ValueError(f"unknown scenario {scenario!r}; one of "
                         f"{SCENARIOS}")
    # heterogeneous turn lengths (tokens_per_turn//2 .. 2x) and wide
    # jittered gaps: long and short turns sharing a gang is exactly
    # where lock-step scheduling leaks slot-time
    shape = SessionShapeDecl(n_turns=n_turns,
                             tokens_per_turn=tokens_per_turn,
                             prompt_len=prompt_len,
                             gap_steps=max(1, horizon // (n_turns + 1)),
                             gap_jitter=0.9)
    slo = SloDecl(deadline_steps=4)
    if scenario == "multi_tenant":
        n_b = n_jobs // 2
        tenants = (
            TenantDecl(name="tenant_a", n_sessions=n_jobs - n_b,
                       session=shape,
                       arrival=ArrivalDecl(kind="stationary"), slo=slo),
            TenantDecl(name="tenant_b", n_sessions=n_b, session=shape,
                       arrival=ArrivalDecl(kind="scan_flood", period=30,
                                           burst_len=6), slo=slo))
    else:
        arrival = {
            "zipf": ArrivalDecl(kind="stationary"),
            "scan_flood": ArrivalDecl(kind="scan_flood", period=40,
                                      burst_len=8),
            "diurnal": ArrivalDecl(kind="diurnal", period=horizon),
        }[scenario]
        tenants = (TenantDecl(name="kv", n_sessions=n_jobs,
                              session=shape, arrival=arrival, slo=slo),)
    decl = WorkloadDecl(tenants=tenants, horizon_steps=horizon,
                        seed=seed * 7919 + SCENARIOS.index(scenario))
    return compile_workload(decl).jobs(vocab=vocab)


def compare_scheduling(engine_factory, jobs_factory, *,
                       pause_idle_steps: int = 4,
                       prefetch_lead="p99",
                       max_ticks: int = 100_000) -> Dict[str, object]:
    """Race continuous batching against the lock-step gang on identical
    jobs and fresh engines. Greedy decode means both arms must emit
    byte-identical tokens per session — asserted here, not assumed —
    so the race is purely about scheduling: modeled tokens/sec and
    per-token stall (restore stalls + idle-slot rent)."""
    cont_engine = engine_factory()
    sched = ContinuousScheduler(cont_engine,
                                pause_idle_steps=pause_idle_steps,
                                prefetch_lead=prefetch_lead)
    cont_jobs = jobs_factory()
    cont = sched.run(cont_jobs, max_ticks=max_ticks)

    lock_engine = engine_factory()
    lock_jobs = jobs_factory()
    lock = run_lockstep(lock_engine, lock_jobs, max_ticks=max_ticks)

    tokens_by_sid = {}
    for j in cont_jobs:
        tokens_by_sid[j.sid] = list(j.request.generated)
    mismatches = [j.sid for j in lock_jobs
                  if list(j.request.generated) != tokens_by_sid[j.sid]]
    return {
        "continuous": cont,
        "lockstep": lock,
        "tokens_identical": not mismatches,
        "token_mismatches": mismatches,
        "throughput_ratio": (cont["tokens_per_sec"]
                             / max(lock["tokens_per_sec"], 1e-12)),
        "stall_ratio": (cont["per_token_stall"]
                        / max(lock["per_token_stall"], 1e-12)),
        "continuous_wins": (
            cont["tokens_per_sec"] >= lock["tokens_per_sec"] - 1e-9
            and cont["per_token_stall"] <= lock["per_token_stall"] + 1e-9),
    }
