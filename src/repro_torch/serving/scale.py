"""Control-plane scale replay: 1M keys / 100k sessions per fleet step.

"Tearing Down the Memory Wall" (PAPERS.md) argues the host *control
plane*, not the flash media, is what caps AI-era hierarchies at high
IOPS — the paper's seconds-scale break-even only matters if routing,
reuse tracking and admission can keep up with millions of fine-grained
residency decisions. This module measures exactly that on this repo's
control plane, post-vectorization:

  * routing: `ShardedTieredStore.owner_batch` (one `searchsorted` over
    the ring arrays; key digests hashed once and reused every step),
  * reuse tracking: `ReuseTracker.observe_batch` over the array-backed
    ghost + one decayed-sketch update per step,
  * admission + capacity: a vectorized break-even gate (measured
    interval vs `tau_be`, class-quantile prior for first touches) and
    an array LRU over the DRAM tier,
  * stall pricing: the step's queued flash misses priced through
    `SsdQueueModel.service_total_batch` (a precomputed cumulative
    depth ladder — no per-fetch model calls).

Wall-clock control-plane cost is timed per section and returned in a
*separate* record from the modeled results: the modeled record (stall,
hit rates, op counters) is deterministic for a seed and byte-stable
across runs — that is what `python -m
repro_torch.benchmarks.serving_scale` JSON-diffs — while the timings
depend on the machine and go to stderr.

The one device in the loop is the reuse sketch: the `ReuseTracker`
keeps it on `device` (CUDA unless the caller asks for the CPU), and
each step is one `reuse_sketch` launch (at the default sizes a step's
~51,700 accesses take the kernel's large path). Routing, the ghost, admission, the LRU and
stall pricing stay host numpy, as in the reference, so the record is
the same on every device.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from .._device import resolve_device
from ..autopilot.reuse import ReuseTracker
from ..runtime.clock import VirtualClock
from ..runtime.fabric import ShardedTieredStore
from ..runtime.service import SsdQueueModel


def generate_scale_trace(*, n_keys: int, n_sessions: int, n_steps: int,
                         accesses_per_step: int, turns_per_session: int,
                         zipf_alpha: float = 3.0,
                         seed: int = 0) -> List[np.ndarray]:
    """Seeded per-step access-id arrays over a keyspace of `n_keys`,
    rendered through the `WorkloadDecl` compiler (the same generator
    behind `jobs_from_trace` and the autopilot traces).

    Two declared tenants: "kv" holds `n_sessions` sessions taking
    `turns_per_session` turns each (ids [0, n_sessions) — their keys
    re-appear at measurable reuse intervals), and "obj" is a stationary
    background stream of `accesses_per_step` one-shot objects per step
    drawn with power-law popularity over ids [n_sessions, n_keys) —
    the scan-flood-ish background the gate must keep out of DRAM.
    A pure function of the arguments."""
    if n_sessions >= n_keys:
        raise ValueError("need n_keys > n_sessions")
    from ..platform.spec import (ArrivalDecl, SessionShapeDecl,
                                 TenantDecl, WorkloadDecl)
    from ..platform.workload import compile_workload
    decl = WorkloadDecl(
        tenants=(
            TenantDecl(
                name="kv", n_sessions=n_sessions,
                session=SessionShapeDecl(
                    n_turns=turns_per_session,
                    gap_steps=max(1, n_steps // (turns_per_session + 1)),
                    gap_jitter=0.9),
                arrival=ArrivalDecl(kind="stationary")),
            TenantDecl(
                name="obj", n_sessions=0,
                arrival=ArrivalDecl(
                    kind="stationary",
                    background_per_step=accesses_per_step,
                    background_pool=n_keys - n_sessions,
                    background_zipf=zipf_alpha)),
        ),
        horizon_steps=n_steps, seed=seed)
    steps, _, _ = compile_workload(decl).id_steps()
    return steps


def _prior_or_inf(quantile: Optional[float]) -> float:
    """Class-sketch prior -> admission estimate: None (no evidence)
    means "never reused" for the vectorized gate. An explicit None
    check — `quantile or np.inf` would also send a legitimate 0.0
    prior (maximally hot) to infinity (maximally cold)."""
    return np.inf if quantile is None else float(quantile)


def scale_replay(*, n_keys: int = 1_000_000, n_sessions: int = 100_000,
                 n_steps: int = 120, accesses_per_step: int = 50_000,
                 turns_per_session: int = 3, n_hosts: int = 8,
                 dram_capacity_keys: Optional[int] = None,
                 l_blk: int = 128 << 10, tau_be: float = 5.0,
                 step_time: float = 0.25, zipf_alpha: float = 3.0,
                 seed: int = 0, sim_cfg=None,
                 trace: Optional[List[np.ndarray]] = None,
                 obs=None,
                 device: Optional[Union[str, torch.device]] = None
                 ) -> Tuple[Dict[str, float], Dict[str, float]]:
    """Replay the scale trace through the vectorized control plane.

    Returns `(record, timings)`: `record` is deterministic (modeled
    stall, hit/admission counters, per-section op counts) and safe to
    byte-diff across runs; `timings` is measured wall-clock seconds per
    control-plane section on this machine (reported separately — never
    mixed into the modeled numbers). Pass `trace` (per-step id arrays,
    ids < n_sessions classed "kv", the rest "obj") to replay a custom
    access pattern — e.g. a `CompiledWorkload.id_steps()` rendering —
    instead of the generated one.

    `obs` (a `repro_torch.obs.Observability`) keeps the metrics plane on
    during the replay: per-step batch observes into array-backed
    counters/gauges/histograms (per-host routing labels included) plus
    the step stall booked to the ledger's `flash_service` component.
    The modeled `record` is byte-identical with or without it; the
    metric cost lands in its own `timings["metrics"]` section.

    `device` holds the tracker's sketch: CUDA unless the caller asks for
    the CPU (without CUDA and without `device=` this raises). The record
    does not depend on it."""
    device = resolve_device(device)
    if dram_capacity_keys is None:
        dram_capacity_keys = n_keys // 10
    if trace is None:
        trace = generate_scale_trace(
            n_keys=n_keys, n_sessions=n_sessions, n_steps=n_steps,
            accesses_per_step=accesses_per_step,
            turns_per_session=turns_per_session, zipf_alpha=zipf_alpha,
            seed=seed)

    fabric = ShardedTieredStore(n_hosts, clock=VirtualClock())
    tracker = ReuseTracker(ghost_capacity=n_keys, n_buckets=32,
                           tau0=1e-3, decay=0.995, max_classes=4,
                           device=device)
    kv_cid = tracker.class_id("kv")
    obj_cid = tracker.class_id("obj")

    # one-time digest pass: routing for the rest of the replay is pure
    # array math (digests survive ring changes)
    t0 = time.perf_counter()
    digests = fabric.key_digest_batch(np.arange(n_keys))
    t_digest = time.perf_counter() - t0

    # flash stall ladder: cumulative cost of n queued misses in a step
    # (depth ramps 1..d_max as the queue builds, then saturates)
    model = SsdQueueModel.shared(sim_cfg)
    d_max = SsdQueueModel.DEPTHS[-1]
    per_depth = model.service_total_batch(l_blk, np.arange(1, d_max + 1))
    cum_stall = np.concatenate([[0.0], np.cumsum(per_depth)])
    sat_cost = float(per_depth[-1])

    resident = np.zeros(n_keys, bool)       # DRAM residency
    last_access = np.full(n_keys, -1, np.int64)
    owner_counts = np.zeros(n_hosts, np.int64)

    counters = {"accesses": 0, "ring_lookups": 0, "ghost_touches": 0,
                "sketch_updates": 0, "admitted": 0, "evicted": 0,
                "dram_hits": 0, "flash_misses": 0, "first_touches": 0}
    timings = {"digest": t_digest, "routing": 0.0, "tracking": 0.0,
               "admission": 0.0, "stall_pricing": 0.0, "metrics": 0.0}
    total_stall = 0.0

    metrics = obs.metrics if obs is not None else None
    ledger = obs.ledger if obs is not None else None
    if metrics is not None:
        m_acc = metrics.counter("scale_accesses")
        m_hits = metrics.counter("scale_dram_hits")
        m_miss = metrics.counter("scale_flash_misses")
        m_routed = metrics.counter("scale_routed")
        m_res = metrics.gauge("scale_dram_resident")
        m_stall = metrics.histogram("scale_step_stall")
        host_labels = [(f"host{h}",) for h in range(n_hosts)]

    for t, ids in enumerate(trace):
        n = ids.size
        now = (t + 1) * step_time
        counters["accesses"] += n

        w0 = time.perf_counter()
        owners = fabric.owner_batch(digests=digests[ids])
        np.add.at(owner_counts, owners, 1)
        counters["ring_lookups"] += n
        w1 = time.perf_counter()
        cids = np.where(ids < n_sessions, kv_cid, obj_cid).astype(np.int32)
        intervals = tracker.observe_batch(ids.tolist(), cids, now)
        counters["ghost_touches"] += n
        counters["sketch_updates"] += 1
        w2 = time.perf_counter()

        # vectorized break-even admission: measured reuse wins, the
        # class sketch quantile covers first touches (the EconomicGate
        # cascade, array-shaped)
        measured = intervals > 0
        counters["first_touches"] += int(n - measured.sum())
        prior = np.empty(2)
        prior[0] = _prior_or_inf(tracker.class_quantile("kv", 0.5))
        prior[1] = _prior_or_inf(tracker.class_quantile("obj", 0.5))
        est = np.where(measured, intervals,
                       prior[(ids >= n_sessions).astype(np.int64)])
        hit = resident[ids]
        admit = (~hit) & (est < tau_be)
        resident[ids[admit]] = True
        last_access[ids] = t
        # array LRU: one partition evicts everything over capacity. It
        # stays numpy: every key touched this step shares last_access ==
        # t, so the capacity boundary almost always falls inside a tie,
        # and only numpy's argpartition picks the reference's victims
        # among the tied keys (torch.topk / kthvalue would pick others,
        # and the hit rate, admissions and stall would drift after it)
        over = int(resident.sum()) - dram_capacity_keys
        if over > 0:
            rows = np.flatnonzero(resident)
            victims = rows[np.argpartition(last_access[rows],
                                           over - 1)[:over]]
            resident[victims] = False
            counters["evicted"] += over
        w3 = time.perf_counter()

        # modeled stall: this step's flash misses queue behind each
        # other; price the ramp off the precomputed ladder. Misses
        # dedupe per step: the *first* touch of a non-resident key
        # queues the flash fetch, later touches in the same step are
        # served by it (DRAM hits) — one cold key touched 50x in a
        # step is 1 queued miss, not 50
        n_miss = int(np.unique(ids[~hit]).size)
        stall = float(cum_stall[min(n_miss, d_max)]
                      + max(0, n_miss - d_max) * sat_cost)
        total_stall += stall
        counters["dram_hits"] += int(n - n_miss)
        counters["flash_misses"] += n_miss
        counters["admitted"] += int(admit.sum())
        w4 = time.perf_counter()

        if ledger is not None and stall:
            # coarse Eq. 1 attribution for the vectorized path: the
            # whole priced step stall is flash service time
            ledger.add("flash_service", stall)
        if metrics is not None:
            m_acc.inc(v=float(n))
            m_hits.inc(v=float(n - n_miss))
            m_miss.inc(v=float(n_miss))
            m_res.set(v=float(resident.sum()))
            m_stall.observe(stall)
            routed = np.bincount(owners, minlength=n_hosts)
            for h in range(n_hosts):
                m_routed.inc(host_labels[h], float(routed[h]))
        w5 = time.perf_counter()

        timings["routing"] += w1 - w0
        timings["tracking"] += w2 - w1
        timings["admission"] += w3 - w2
        timings["stall_pricing"] += w4 - w3
        timings["metrics"] += w5 - w4

    accesses = counters["accesses"]
    record = {
        "n_keys": float(n_keys), "n_sessions": float(n_sessions),
        "n_steps": float(n_steps), "n_hosts": float(n_hosts),
        "accesses": float(accesses),
        "dram_capacity_keys": float(dram_capacity_keys),
        "tau_be": float(tau_be), "step_time": float(step_time),
        "hit_rate": counters["dram_hits"] / max(accesses, 1),
        "measured_rate": tracker.measured / max(tracker.observed, 1),
        "total_stall": total_stall,
        "per_access_stall": total_stall / max(accesses, 1),
        "owner_imbalance": float(owner_counts.max()
                                 / max(owner_counts.mean(), 1e-12)),
        "ghost_size": float(len(tracker._last_seen)),
    }
    for k, v in counters.items():
        record[f"ops_{k}"] = float(v)
    timings["total"] = sum(timings.values())
    timings["keys_per_sec"] = accesses / max(
        timings["total"] - timings["digest"], 1e-12)
    return record, timings
