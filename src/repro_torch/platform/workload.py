"""WorkloadDecl compiler: declared scenarios -> jobs, traces, thresholds.

`compile_workload` is one generator over a declared `WorkloadDecl`:
every tenant's arrival process, session shape and SLO compile into

  * `jobs()`     — tenant-tagged multi-turn `SessionJob` lists for the
                   `ContinuousScheduler` (session ids `"{tenant}/NNN"`,
                   so the gate's classifier recovers the tenant),
  * `trace()`    — an `autopilot.traces.Trace` whose keys are
                   `(tenant, id)` tuples for the economics benches,
  * `id_steps()` — dense per-step int-id arrays for a vectorized
                   control-plane replay (`serving.scale`),
  * `tenant_taus()` / `declared_priors()` — per-tenant `tau_be` (each
                   tenant's `alpha_stall` folded in via the same Eq. 1
                   correction `EconomicGate.from_break_even` applies)
                   and declared reuse priors for the `ReuseTracker`.

Everything is drawn from per-tenant numpy rngs seeded by
`(decl.seed, crc32(tenant.name), stream)`, in the reference package's
order, so each product is a pure function of the spec JSON — equal to
the reference's element for element, and byte-identical across
compile -> to_json -> from_json -> compile.
"""
from __future__ import annotations

import zlib
from typing import Dict, List, Optional

import numpy as np

from ..autopilot.traces import Trace
from .spec import TenantDecl, WorkloadDecl

__all__ = ["CompiledWorkload", "compile_workload", "tenant_classifier"]


def _rng(decl: WorkloadDecl, tenant: str, stream: int):
    """Per-(tenant, stream) rng: streams keep jobs/trace/prompt draws
    independent so rendering one product never perturbs another."""
    return np.random.default_rng(
        [decl.seed, zlib.crc32(tenant.encode()), stream])


def tenant_classifier(names):
    """Key -> class fn that recovers the tenant from both key shapes the
    compiler emits: scheduler KV keys `("kv", "{tenant}/NNN")` and trace
    keys `(tenant, id)`. Anything else falls back to the runtime's
    default conventions."""
    from ..autopilot.gate import default_classify
    known = frozenset(names)

    def classify(key) -> str:
        if isinstance(key, tuple) and len(key) == 2:
            head = key[0]
            if head in known:
                return head
            if head == "kv" and isinstance(key[1], str):
                tenant = key[1].split("/", 1)[0]
                if tenant in known:
                    return tenant
        return default_classify(key)

    return classify


class CompiledWorkload:
    """Deterministic rendering of one `WorkloadDecl`. Schedules are
    drawn once at construction; `jobs`/`trace`/`id_steps` are pure
    views over them."""

    def __init__(self, decl: WorkloadDecl):
        decl.validate()
        self.decl = decl
        self.horizon = decl.horizon_steps
        # per tenant: turn schedule (due/new int arrays, [n_sessions x
        # n_turns]), background object ids per step, extra per-turn keys
        self._due: Dict[str, np.ndarray] = {}
        self._new: Dict[str, np.ndarray] = {}
        self._background: Dict[str, List[np.ndarray]] = {}
        self._bg_space: Dict[str, int] = {}
        self._extras: Dict[str, List[np.ndarray]] = {}
        self._extra_space: Dict[str, int] = {}
        for t in decl.tenants:
            due, new = self._schedule(t)
            self._due[t.name], self._new[t.name] = due, new
            bg, bg_space = self._background_stream(t)
            self._background[t.name] = bg
            self._bg_space[t.name] = bg_space
            ex, ex_space = self._extra_stream(t, due)
            self._extras[t.name] = ex
            self._extra_space[t.name] = ex_space

    # ----------------------------------------------------------- drawing
    def _schedule(self, t: TenantDecl):
        """Turn schedule for one tenant: first turns arrive by the
        declared intensity; later turns chain at the declared
        (jittered) think gap after the previous turn's decode."""
        n, turns = t.n_sessions, t.session.n_turns
        rng = _rng(self.decl, t.name, 0)
        mass = t.arrival.intensity(self.horizon)
        cdf = np.cumsum(mass) / mass.sum()
        first = np.searchsorted(cdf, rng.random(n)).astype(np.int64)
        s = t.session
        lo = max(1, s.tokens_per_turn // 2)
        hi = 2 * s.tokens_per_turn
        new = rng.integers(lo, hi, size=(n, turns)).astype(np.int64)
        jitter = 1.0 + s.gap_jitter * (2.0 * rng.random((n, turns)) - 1.0)
        gaps = np.maximum(1, np.rint(s.gap_steps * jitter)).astype(np.int64)
        due = np.empty((n, turns), np.int64)
        if n:
            due[:, 0] = first
            for k in range(1, turns):
                # strictly ordered, leaving decode room for the previous
                # turn — the same invariant jobs_from_trace kept
                due[:, k] = due[:, k - 1] + new[:, k - 1] + gaps[:, k]
        return due, new

    def _background_stream(self, t: TenantDecl):
        """Side-object ids per step: `background_per_step` scaled by the
        arrival intensity, zipf over a pool (or fresh one-touch ids when
        the pool is 0 — the scan shape)."""
        arr = t.arrival
        if arr.background_per_step == 0:
            return [], 0
        rng = _rng(self.decl, t.name, 1)
        mass = arr.intensity(self.horizon)
        counts = np.rint(arr.background_per_step * mass).astype(np.int64)
        total = int(counts.sum())
        if arr.background_pool > 0:
            pool = arr.background_pool
            u = rng.random(total)
            flat = np.minimum((pool * np.power(u, arr.background_zipf))
                              .astype(np.int64), pool - 1)
            space = pool
        else:
            flat = np.arange(total, dtype=np.int64)   # fresh, never reused
            space = total
        bounds = np.concatenate([[0], np.cumsum(counts)])
        steps = [flat[bounds[i]:bounds[i + 1]]
                 for i in range(self.horizon)]
        return steps, space

    def _extra_stream(self, t: TenantDecl, due: np.ndarray):
        """Per-turn side reads (RAG corpus / scan keys): rendered at the
        turn's due step in the access trace."""
        s = t.session
        if s.extra_keys_per_turn == 0 or due.size == 0:
            return [], 0
        rng = _rng(self.decl, t.name, 2)
        turn_steps = due.ravel()
        live = turn_steps < self.horizon
        total = int(live.sum()) * s.extra_keys_per_turn
        if s.extra_key_pool > 0:
            pool = s.extra_key_pool
            u = rng.random(total)
            flat = np.minimum((pool * np.power(u, s.extra_zipf))
                              .astype(np.int64), pool - 1)
            space = pool
        else:
            flat = np.arange(total, dtype=np.int64)
            space = total
        steps: List[np.ndarray] = [np.empty(0, np.int64)
                                   for _ in range(self.horizon)]
        order = np.argsort(turn_steps[live], kind="stable")
        grouped = flat.reshape(-1, s.extra_keys_per_turn)[order]
        srt = turn_steps[live][order]
        bounds = np.searchsorted(srt, np.arange(self.horizon + 1))
        for i in range(self.horizon):
            if bounds[i + 1] > bounds[i]:
                steps[i] = grouped[bounds[i]:bounds[i + 1]].ravel()
        return steps, space

    # ------------------------------------------------------------- views
    def jobs(self, *, vocab: int = 64):
        """Tenant-tagged `SessionJob` list in declared tenant order.
        Session ids are `"{tenant}/{i:03d}"`, so the tenant classifier
        (and per-tenant gate thresholds) see the offloaded KV keys."""
        from ..serving.scheduler import SessionJob, Turn
        jobs = []
        for t in self.decl.tenants:
            due, new = self._due[t.name], self._new[t.name]
            prng = _rng(self.decl, t.name, 3)
            prompts = prng.integers(
                1, vocab, size=(t.n_sessions, t.session.prompt_len)
            ).astype(np.int32)
            dl = t.slo.deadline_steps
            for i in range(t.n_sessions):
                turns = [Turn(due_step=int(due[i, k]),
                              max_new=int(new[i, k]),
                              deadline_steps=dl)
                         for k in range(due.shape[1])]
                jobs.append(SessionJob(sid=f"{t.name}/{i:03d}",
                                       prompt=prompts[i], turns=turns,
                                       tenant=t.name))
        return jobs

    def trace(self, *, step_time: float = 0.25,
              name: str = "workload") -> Trace:
        """Access trace for the autopilot benches. Keys are
        `(tenant, id)` tuples with disjoint per-tenant id spaces:
        sessions `[0, n)`, background objects and per-turn extras
        offset after them — `default_classify` (key[0]) recovers the
        tenant class."""
        steps: List[List[tuple]] = [[] for _ in range(self.horizon)]
        for t in self.decl.tenants:
            due = self._due[t.name]
            flat = due.ravel()
            sids = np.repeat(np.arange(t.n_sessions), due.shape[1])
            live = flat < self.horizon
            order = np.argsort(flat[live], kind="stable")
            srt, ssids = flat[live][order], sids[live][order]
            bounds = np.searchsorted(srt, np.arange(self.horizon + 1))
            bg_off = t.n_sessions
            ex_off = bg_off + self._bg_space[t.name]
            bg, ex = self._background[t.name], self._extras[t.name]
            for i in range(self.horizon):
                step = steps[i]
                step.extend((t.name, int(s))
                            for s in ssids[bounds[i]:bounds[i + 1]])
                if ex:
                    step.extend((t.name, int(ex_off + k))
                                for k in ex[i])
                if bg:
                    step.extend((t.name, int(bg_off + k))
                                for k in bg[i])
        return Trace(name=name, step_time=step_time, steps=steps)

    def id_steps(self):
        """Dense-int rendering for the vectorized control-plane replay:
        `(steps, n_session_ids, n_ids)`. Session ids occupy `[0,
        n_session_ids)` in declared tenant order (so `ids <
        n_session_ids` means "session KV key"), object ids follow."""
        sess_off: Dict[str, int] = {}
        off = 0
        for t in self.decl.tenants:
            sess_off[t.name] = off
            off += t.n_sessions
        n_session_ids = off
        obj_off: Dict[str, int] = {}
        for t in self.decl.tenants:
            obj_off[t.name] = off
            off += self._bg_space[t.name] + self._extra_space[t.name]
        n_ids = off

        steps: List[np.ndarray] = []
        per_tenant_sess: Dict[str, List[np.ndarray]] = {}
        for t in self.decl.tenants:
            due = self._due[t.name]
            flat = due.ravel()
            sids = np.repeat(np.arange(t.n_sessions, dtype=np.int64),
                             due.shape[1])
            live = flat < self.horizon
            order = np.argsort(flat[live], kind="stable")
            srt, ssids = flat[live][order], sids[live][order]
            bounds = np.searchsorted(srt, np.arange(self.horizon + 1))
            per_tenant_sess[t.name] = [
                sess_off[t.name] + ssids[bounds[i]:bounds[i + 1]]
                for i in range(self.horizon)]
        for i in range(self.horizon):
            parts = []
            for t in self.decl.tenants:
                parts.append(per_tenant_sess[t.name][i])
                ex = self._extras[t.name]
                if ex and ex[i].size:
                    parts.append(obj_off[t.name] + ex[i])
                bg = self._background[t.name]
                if bg and bg[i].size:
                    parts.append(obj_off[t.name]
                                 + self._extra_space[t.name] + bg[i])
            steps.append(np.concatenate(parts) if parts
                         else np.empty(0, np.int64))
        return steps, n_session_ids, n_ids

    # -------------------------------------------------------- economics
    def tenant_taus(self, host, ssd, l_blk: float, *,
                    gamma_rw: float = 9.0, phi_wa: float = 3.0,
                    iops_ssd: Optional[float] = None,
                    fetch_seconds: float = 0.0) -> Dict[str, float]:
        """Per-tenant break-even thresholds: each tenant's declared
        `alpha_stall` folded into its own tau_be — a premium tenant's
        stall rents DRAM harder than a batch tenant's."""
        from ..autopilot.gate import EconomicGate
        return {t.name: EconomicGate.breakeven_tau(
            host, ssd, l_blk, gamma_rw=gamma_rw, phi_wa=phi_wa,
            iops_ssd=iops_ssd, alpha_stall=t.slo.alpha_stall,
            fetch_seconds=fetch_seconds)
            for t in self.decl.tenants}

    def declared_priors(self, step_time: float) -> Dict[str, float]:
        """Tenant -> declared reuse interval (seconds): the think gap is
        how long an offloaded KV blob waits before its resume touches
        it. Seeded into the `ReuseTracker` so a tenant's first offload
        is priced by its declaration, not the cold default."""
        if step_time <= 0:
            return {}
        return {t.name: t.session.gap_steps * step_time
                for t in self.decl.tenants}

    def slos(self) -> Dict[str, object]:
        return {t.name: t.slo for t in self.decl.tenants}

    def tenant_names(self) -> List[str]:
        return [t.name for t in self.decl.tenants]


def compile_workload(decl: WorkloadDecl) -> CompiledWorkload:
    """Validate + render a `WorkloadDecl`. Pure in (decl JSON, seed)."""
    return CompiledWorkload(decl)
