"""Kill-a-host-at-diurnal-peak: the availability benchmark.

The paper's economics price DRAM rent against flash IO; this bench
prices *availability*. Three arms replay the same seeded diurnal trace
on the same three-host fleet, differing only in replication factor
r in {1, 2, 3}. At the diurnal peak the busiest host dies unplanned
(`fabric.fail_host` — no drain), the repair loop re-replicates what
survived under the rebalance pacer, and the replay continues through
recovery:

  * a committed key with a surviving replica degrades to a remote read
    (the stall is measured on the shared virtual clock);
  * a committed key whose only copy died is *lost* — its next touch
    pays a modeled recompute stall and re-puts it;
  * in-flight decode sessions checkpoint their KV blob every
    `checkpoint_every` steps (the `DecodeEngine.checkpoint_interval`
    behavior, replayed here at trace scale). A session homed on the
    victim resumes from its last checkpoint on a surviving holder —
    paying the restore fetch plus regeneration of the tokens since the
    checkpoint — or, with no surviving blob, restarts from scratch.

Costs use the same normalized rates as every other cost-reporting
bench (`autopilot.bench.pricing_rates`): DRAM rent on provisioned
capacity, wire bytes, flash pages, host CPU, and stalled-engine time at
`alpha_accel`. The acceptance criterion (asserted in tests, reported by
`python -m repro_torch.benchmarks.serving_autopilot --failover`): with
r >= 2 zero
committed keys are lost and every session resumes, and the advisor's
recommended replication factor (`advise_availability` under the bench's
MTTF) beats both r=1 and r=3 on measured $/token.

Deterministic by construction: seeded trace, one `VirtualClock` per
arm, deterministic victim selection (max resident bytes, ties to the
smallest id) — the emitted JSON is byte-identical across runs, across
devices (`device` holds each arm's fleet reuse sketch: the reuse_sketch
kernel on CUDA, its plain version on the CPU), and to the reference
package's.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Union

import numpy as np
import torch

from ..autopilot.bench import PAGE_BYTES, pricing_rates
from ..autopilot.traces import generate
from ..core.policy import Tier
from ..runtime.repair import RepairLoop
from .spec import HierarchySpec, HostDecl, PolicyDecl, TierDecl


def default_failover_spec(l_blk: int = 128 << 10, *,
                          n_hosts: int = 4,
                          alpha_stall: float = 4.0,
                          dram_blocks_per_host: int = 20,
                          rebalance_rate: Optional[float] = 2e9,
                          replicas: int = 1) -> HierarchySpec:
    """A homogeneous fleet sized like the autoscale bench's hosts; the
    bench swaps `replicas` per arm."""
    host = HostDecl(count=n_hosts, tiers={
        "hbm": TierDecl(2 * l_blk, 819e9, 1e-7),
        "dram": TierDecl(dram_blocks_per_host * l_blk, 45e9, 5e-7),
        "flash": TierDecl(1 << 34, 7e9, 2e-5),
    })
    return HierarchySpec(
        hosts=(host,),
        policy=PolicyDecl.economic(l_blk=l_blk, alpha_stall=alpha_stall),
        rebalance_rate=rebalance_rate,
        replicas=replicas)


def _busiest_host(fabric) -> int:
    """Deterministic victim: most resident bytes, ties to smallest id."""
    loads = {h: sum(s.used_bytes(t) for t in Tier)
             for h, s in sorted(fabric.hosts.items())}
    return max(sorted(loads), key=lambda h: loads[h])


def _run_failover_arm(spec: HierarchySpec, trace, *, replicas: int,
                      l_blk: int, step_time: float,
                      tokens_per_step: int, alpha_accel: float,
                      kill_step: int, n_sessions: int,
                      checkpoint_every: int,
                      lost_recompute_seconds: float,
                      sim_cfg=None,
                      device: Optional[Union[str, torch.device]] = None
                      ) -> Dict[str, object]:
    from .compiler import Platform
    spec = dataclasses.replace(spec, replicas=replicas)
    platform = Platform.compile(spec, sim_cfg=sim_cfg, device=device)
    fabric, clock = platform.fabric, platform.clock
    host_cfg, ssd = spec.policy.economics()
    blob = np.zeros(max(l_blk // 4, 1), np.float32)

    # in-flight decode sessions, replayed at trace scale: one KV blob
    # each, re-put (checkpointed) every `checkpoint_every` steps from
    # its home host — the DecodeEngine.checkpoint_interval behavior
    sessions = [("sess", i) for i in range(n_sessions)]
    sess_home = {s: fabric.owner(s) for s in sessions}
    sess_ckpt_step = {s: 0 for s in sessions}
    for s in sessions:
        fabric.put(s, blob, tier=Tier.DRAM, from_host=sess_home[s],
                   replicas=replicas)

    total_stall = 0.0
    first_touches = 0
    put_bytes = float(n_sessions * blob.nbytes)
    provisioned_byte_seconds = 0.0
    committed: set = set(sessions)
    lost_key_stalls = 0
    report = None
    repair = None
    recovery_seconds = 0.0
    committed_lost = 0
    sessions_lost = 0
    sessions_resumed = 0
    last_t = clock.now()

    for t, step in enumerate(trace.steps):
        if t == kill_step:
            victim = _busiest_host(fabric)
            report = fabric.fail_host(victim)
            committed_lost = sum(1 for k in report.lost_keys
                                 if k in committed)
            repair = RepairLoop(fabric).run()
            recovery_seconds = max(0.0, repair.t_done - report.t_fail)
            # failover: sessions homed on the victim resume from their
            # last checkpoint on a surviving holder, or restart
            for s in sessions:
                if sess_home[s] != victim:
                    continue
                new_home = fabric.preferred_host(s)
                if new_home is not None:
                    t0 = clock.now()
                    fabric.get(s, from_host=new_home)
                    # restore fetch + regenerate tokens lost since the
                    # last checkpoint (greedy decode is deterministic)
                    total_stall += (clock.now() - t0
                                    + (t - sess_ckpt_step[s]) * step_time)
                    sessions_resumed += 1
                else:
                    # torn session: no surviving blob, full restart
                    total_stall += t * step_time
                    sessions_lost += 1
                    fabric.put(s, blob, tier=Tier.DRAM,
                               from_host=fabric.owner(s),
                               replicas=replicas)
                    put_bytes += blob.nbytes
                sess_home[s] = fabric.owner(s)
                sess_ckpt_step[s] = t
        for key in step:
            h = fabric.owner(key)
            if fabric.tier_of(key) is None:
                if key in committed:
                    # committed key lost to the failure: its next touch
                    # pays the modeled recompute before the re-put
                    lost_key_stalls += 1
                    total_stall += lost_recompute_seconds
                fabric.put(key, blob, tier=Tier.DRAM, from_host=h,
                           replicas=replicas)
                first_touches += 1
                put_bytes += blob.nbytes
                committed.add(key)
            else:
                t0 = clock.now()
                fabric.get(key, from_host=h)
                total_stall += clock.now() - t0
        if checkpoint_every and (t + 1) % checkpoint_every == 0:
            for s in sessions:
                fabric.put(s, blob, tier=Tier.DRAM,
                           from_host=sess_home[s], replicas=replicas)
                put_bytes += blob.nbytes
                sess_ckpt_step[s] = t + 1
        clock.advance(step_time)
        now = clock.now()
        dt = now - last_t
        for store in fabric.hosts.values():
            provisioned_byte_seconds += \
                store.specs[Tier.DRAM].capacity_bytes * dt
        last_t = now
    horizon = clock.now()
    platform.drain()

    # ------------------------------------------------------- cost model
    rates = pricing_rates(host_cfg, ssd)
    flash_pages = 0
    dram_bytes_moved = 0
    total_ios = 0
    for store in fabric._all_stores():
        q = store.runtime.qstats
        flash_pages += -(-q[Tier.FLASH].bytes_moved // PAGE_BYTES)
        dram_bytes_moved += (q[Tier.DRAM].bytes_moved
                             + q[Tier.HBM].bytes_moved)
        total_ios += sum(s.submitted for s in q.values())
    tokens = trace.n_steps * tokens_per_step
    cost = {
        "dram_rent": provisioned_byte_seconds * rates["rent_rate"],
        "dram_wire": dram_bytes_moved * rates["dram_wire_rate"],
        "flash_io": flash_pages * rates["page_io_cost"],
        "host_cpu": total_ios * rates["host_io_cost"],
        "stall": total_stall * alpha_accel,
    }
    total_cost = float(sum(cost.values()))

    out: Dict[str, object] = {
        "replicas": float(replicas),
        "horizon": float(horizon),
        "tokens": float(tokens),
        "first_touches": float(first_touches),
        "put_bytes": float(put_bytes),
        "total_stall": float(total_stall),
        "per_token_stall": float(total_stall / max(tokens, 1)),
        "cost_total": total_cost,
        "cost_per_token": float(total_cost / max(tokens, 1)),
        "recovery_seconds": float(recovery_seconds),
        "committed_keys_lost": float(committed_lost),
        "lost_key_stalls": float(lost_key_stalls),
        "sessions": float(n_sessions),
        "sessions_resumed": float(sessions_resumed),
        "sessions_lost": float(sessions_lost),
        "remote_puts": float(fabric.remote_puts),
    }
    out.update({f"cost_{k}": float(v) for k, v in cost.items()})
    if report is not None:
        out["failure"] = report.as_dict()
    if repair is not None:
        out["repair"] = repair.as_dict()
    return out


def run_failover_bench(spec: Optional[HierarchySpec] = None, *,
                       scenario: str = "diurnal",
                       n_steps: int = 240,
                       step_time: float = 0.25,
                       l_blk: int = 128 << 10,
                       tokens_per_step: int = 16,
                       alpha_accel: float = 4.0,
                       kill_at_frac: float = 0.5,
                       n_sessions: int = 12,
                       checkpoint_every: int = 8,
                       lost_recompute_seconds: float = 1.0,
                       mttf: Optional[float] = None,
                       seed: int = 0,
                       sim_cfg=None,
                       device: Optional[Union[str, torch.device]] = None
                       ) -> Dict[str, object]:
    """Replication arms r in {1, 2, 3} through the same kill-at-peak
    scenario, plus the advisor's recommendation under the bench's MTTF.

    `mttf` defaults to `n_hosts * horizon` — exactly one expected host
    failure over the replayed window, so the single measured kill is a
    faithful draw from the modeled failure process. `device` holds the
    fleet trackers' sketch: CUDA unless the caller names the CPU."""
    spec = spec if spec is not None else default_failover_spec(
        l_blk, alpha_stall=alpha_accel)
    trace = generate(scenario, n_steps=n_steps, step_time=step_time,
                     seed=seed)
    kill_step = max(1, min(n_steps - 2, int(n_steps * kill_at_frac)))
    kw = dict(l_blk=l_blk, step_time=step_time,
              tokens_per_step=tokens_per_step, alpha_accel=alpha_accel,
              kill_step=kill_step, n_sessions=n_sessions,
              checkpoint_every=checkpoint_every,
              lost_recompute_seconds=lost_recompute_seconds,
              sim_cfg=sim_cfg, device=device)
    arms = {r: _run_failover_arm(spec, trace, replicas=r, **kw)
            for r in (1, 2, 3)}

    horizon = float(arms[1]["horizon"])
    mttf_eff = float(mttf) if mttf is not None \
        else spec.n_hosts * horizon
    # price availability from the surviving fleet's live state; the
    # put stream feeds the write-cost term
    from .compiler import Platform
    probe = Platform.compile(spec, sim_cfg=sim_cfg, device=device)
    advisor = probe.advisor
    put_rate = float(arms[1]["put_bytes"]) / max(horizon, 1e-9)
    # unique committed payload: one blob per distinct key + session
    # (put_bytes also counts checkpoint re-puts, so it is the write
    # stream, not the census)
    resident = (float(arms[1]["first_touches"]) + n_sessions) \
        * float(max(l_blk // 4, 1) * 4)
    advice = advisor.advise_availability(
        resident_bytes=resident, n_hosts=spec.n_hosts,
        dram_fraction=0.35, mttf=mttf_eff,
        alpha_stall=alpha_accel,
        recompute_seconds=lost_recompute_seconds,
        put_bytes_per_second=put_rate)
    rec = advice.recommended_replicas

    cpt = {r: float(arms[r]["cost_per_token"]) for r in arms}
    return {
        "scenario": scenario,
        "params": {"n_steps": n_steps, "step_time": step_time,
                   "l_blk": l_blk, "alpha_accel": alpha_accel,
                   "kill_step": kill_step, "n_sessions": n_sessions,
                   "checkpoint_every": checkpoint_every,
                   "lost_recompute_seconds": lost_recompute_seconds,
                   "mttf": mttf_eff, "seed": seed},
        "arms": {str(r): arms[r] for r in sorted(arms)},
        "advice": advice.as_dict(),
        "recommended_replicas": float(rec),
        "recommended_wins": bool(
            cpt[rec] <= min(cpt[r] for r in arms if r != rec) + 1e-12),
        "zero_committed_loss_replicated": bool(
            all(arms[r]["committed_keys_lost"] == 0
                for r in (2, 3))),
        "all_sessions_resume_replicated": bool(
            all(arms[r]["sessions_lost"] == 0 for r in (2, 3))),
    }
