"""Scenario-diverse access-trace generator for the autopilot benchmark.

Four canonical cache-adversarial shapes, all deterministic under a seed
and expressed as decode steps (one step = `step_time` seconds of
compute; each step touches a small batch of keys):

  * ``zipf``          — stationary skewed popularity: a hot head reused
                        every few steps, a long tail reused rarely.
  * ``scan_flood``    — the same hot core plus periodic one-touch floods
                        of *fresh* keys (class "scan"): the classic
                        LRU-killer; an admission gate must keep the
                        flood out of DRAM.
  * ``diurnal``       — the hot set migrates from pool A to pool B over
                        the trace (hotspot shift): yesterday's hot keys
                        squat in DRAM unless staleness-aware demotion
                        reclaims them.
  * ``multi_tenant``  — a steady tenant plus a bursty tenant (distinct
                        key classes): within a burst the bursty keys are
                        economically hot, between bursts they are not.

Keys are `(class, id)` tuples, so `autopilot.gate.default_classify`
recovers the class and the per-class sketch learns separate priors.
The traces are the reference's step for step: the same `default_rng`
draws in the same order. `from_workload` renders a declared workload
through `platform.workload`.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

SCENARIOS = ("zipf", "scan_flood", "diurnal", "multi_tenant")

Access = Tuple[tuple, str]          # (key, class)


@dataclasses.dataclass(frozen=True)
class Trace:
    name: str
    step_time: float
    steps: List[List[tuple]]        # per step: keys touched (in order)

    @property
    def n_steps(self) -> int:
        return len(self.steps)

    def distinct_keys(self) -> List[tuple]:
        seen = dict.fromkeys(k for step in self.steps for k in step)
        return list(seen)

    @property
    def accesses(self) -> int:
        return sum(len(s) for s in self.steps)


def _zipf_weights(n: int, a: float) -> np.ndarray:
    w = np.power(np.arange(1, n + 1, dtype=float), -a)
    return w / w.sum()


def generate(name: str, *, n_steps: int = 240, step_time: float = 0.25,
             seed: int = 0) -> Trace:
    """Build one scenario trace. All randomness comes from a
    scenario-salted `default_rng`, so (name, n_steps, seed) fully
    determine the byte-exact access sequence."""
    if name not in SCENARIOS:
        raise ValueError(f"unknown scenario {name!r}; one of {SCENARIOS}")
    rng = np.random.default_rng(seed * 1009 + SCENARIOS.index(name))
    steps: List[List[tuple]] = []

    if name == "zipf":
        n_keys, per_step = 48, 4
        w = _zipf_weights(n_keys, 1.1)
        for _ in range(n_steps):
            ids = rng.choice(n_keys, size=per_step, p=w)
            steps.append([("kv", int(i)) for i in ids])

    elif name == "scan_flood":
        n_hot, per_step = 24, 3
        w = _zipf_weights(n_hot, 1.2)
        flood_every, flood_len, flood_per_step = 40, 8, 4
        flood_id = 0
        for t in range(n_steps):
            step = [("kv", int(i))
                    for i in rng.choice(n_hot, size=per_step, p=w)]
            if (t % flood_every) < flood_len:
                # one-touch keys, fresh every flood: never reused
                for _ in range(flood_per_step):
                    step.append(("scan", flood_id))
                    flood_id += 1
            steps.append(step)

    elif name == "diurnal":
        pool, per_step = 24, 4
        w = _zipf_weights(pool, 1.2)
        for t in range(n_steps):
            # phase 0 -> pool A hot; phase 1 -> pool B hot; smooth shift
            p = float(np.clip((t - n_steps / 3) / (n_steps / 3), 0.0, 1.0))
            step = []
            for _ in range(per_step):
                which = pool if rng.random() < p else 0
                step.append(("kv", int(which + rng.choice(pool, p=w))))
            steps.append(step)

    else:                                            # multi_tenant
        n_a, n_b = 16, 16
        w_a = _zipf_weights(n_a, 1.2)
        w_b = _zipf_weights(n_b, 0.8)
        burst_every, burst_len = 30, 6
        for t in range(n_steps):
            step = [("tenant_a", int(i))
                    for i in rng.choice(n_a, size=2, p=w_a)]
            if (t % burst_every) < burst_len:
                step += [("tenant_b", int(i))
                         for i in rng.choice(n_b, size=4, p=w_b)]
            steps.append(step)

    return Trace(name=name, step_time=step_time, steps=steps)


def from_workload(decl, *, step_time: float = 0.25,
                  name: str = "workload") -> Trace:
    """Render a declared multi-tenant scenario (`WorkloadDecl`, see
    `repro_torch.platform.spec`) as an access trace: keys are `(tenant,
    id)` tuples, so the per-class sketch learns separate per-tenant
    priors — the declared counterpart of the hand-coded shapes above."""
    from ..platform.workload import compile_workload
    return compile_workload(decl).trace(step_time=step_time, name=name)
