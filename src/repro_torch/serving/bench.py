"""Modeled multi-turn session-serving benchmark: sync vs async KV restore.

The paper's LLM-memory workload (§VII-A): sessions pause between turns,
their KV blocks living on flash, and resume later. A synchronous restore
fetches KV at resume — every turn begins with the full flash fetch
stalling decode. The async runtime overlaps: the next session's KV
restore is issued `lead` decode steps early and streams behind the
current session's compute, so resume blocks only on the unfinished
remainder. `lead="p99"` sizes that lead per turn from the calibrated
open-loop p99 of the tier that will serve the fetch
(`ceil(p99_estimate / step_time)` steps early) instead of a fixed count.

Everything runs on a `VirtualClock` with queueing-aware flash service
times from the calibrated ssdsim model, so the output is a deterministic
*modeled* per-token stall — comparable across modes, independent of host
speed. Run `python -m repro_torch.benchmarks.serving_async` for the CLI
report.

`multi_host_session_bench` scales the same workload onto the sharded
fabric: sessions pause on one host and resume on another (chosen by a
seeded schedule, optionally Zipf-skewed toward hot sessions), so most
restores cross the NIC transfer tier composed with the owner host's
flash queue. `locality=True` reroutes each resume to a host already
holding the session's KV replica (remote restores become local reads);
`churn={"join_turn": t}` (and/or `"leave_turn"`) makes the fleet
elastic mid-schedule — the fabric streams the remapped ~1/N of keys as
background rebalance traffic and the benchmark prices the rebalance tax
as added stall per token (see `compare_churn`). Run
`python -m repro_torch.benchmarks.serving_fleet` for the host-count x
skew sweep and the `--churn` elasticity report. The fleet benches are
host Python on the virtual clock; only a `spec=` fleet with economic
gates keeps the gates' reuse sketches on a device (`device=`). The 1M-key
control-plane replay is `serving.scale`; the continuous scheduler is
`serving.scheduler`.
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch

from ..core.policy import Tier, TieringPolicy
from ..runtime.clock import VirtualClock
from ..runtime.fabric import ShardedTieredStore
from ..runtime.tiers import TieredStore


def _lead_steps(lead, store, key, step_time: float, decode_steps: int,
                **kw) -> int:
    """Fixed lead -> as given; "p99" -> sized from the serving tier's
    calibrated tail so the estimate is covered (capped at a full turn)."""
    if lead == "p99":
        return min(decode_steps,
                   store.prefetch_lead_steps(key, step_time, **kw))
    return int(lead)


def multi_turn_session_bench(mode: str = "async", *,
                             n_sessions: int = 16,
                             rounds: int = 3,
                             kv_bytes: int = 2 << 20,
                             decode_steps: int = 32,
                             step_time: float = 2e-3,
                             lead=8,
                             sim_cfg=None) -> Dict[str, float]:
    """Round-robin multi-turn serving on the virtual clock.

    Each round resumes every session once: restore KV (sync fetch, or a
    prefetch issued `lead` steps before the previous session finishes —
    `lead="p99"` sizes it from the flash tier's calibrated tail), decode
    `decode_steps` tokens at `step_time`, pause (KV back to flash).
    Returns modeled totals incl. per-token stall.
    """
    assert mode in ("sync", "async"), mode
    # thresholds pinned so session KV stays on the flash tier: the
    # benchmark measures the restore path, not placement churn
    policy = TieringPolicy(tau_hot=1e-12, tau_be=1e-9, ema_alpha=1.0)
    clock = VirtualClock()
    store = TieredStore(policy, clock=clock, sim_cfg=sim_cfg)
    blob = np.zeros(kv_bytes // 4, np.float32)
    keys = [("kv", f"s{i}") for i in range(n_sessions)]
    for k in keys:
        store.put(k, blob, tier=Tier.FLASH)
    store.runtime.drain()
    store.reset_stats()         # measured phase only, not setup writes

    total_stall = 0.0
    tokens = 0
    pending = {}
    for _ in range(rounds):
        for i, key in enumerate(keys):
            # --- restore ------------------------------------------------
            t0 = clock.now()
            pf = pending.pop(key, None)
            if pf is None:
                pf = store.get_async(key)
            pf.wait()
            total_stall += clock.now() - t0
            # --- decode, issuing the next session's prefetch mid-turn ---
            nxt = keys[(i + 1) % n_sessions]
            prefetch_at = decode_steps
            if (mode == "async" and nxt not in pending and nxt != key
                    and store.tier_of(nxt) is not None):
                prefetch_at = max(0, decode_steps - _lead_steps(
                    lead, store, nxt, step_time, decode_steps))
            for s in range(decode_steps):
                if s == prefetch_at:
                    pending[nxt] = store.get_async(nxt)
                clock.advance(step_time)
            tokens += decode_steps
            # --- pause (write streams in the background) -----------------
            store.put(key, blob, tier=Tier.FLASH)

    flash = store.stats[Tier.FLASH]
    return {
        "mode": mode,
        "tokens": float(tokens),
        "total_stall": total_stall,
        "per_token_stall": total_stall / max(tokens, 1),
        "makespan": clock.now(),
        "prefetch_hits": float(flash.prefetch_hits),
        "prefetch_late": float(flash.prefetch_late),
        "miss_under_miss": float(
            store.runtime.qstats[Tier.FLASH].miss_under_miss),
    }


def compare(**kw) -> Dict[str, Dict[str, float]]:
    """Run both modes on identical workloads; async must stall less."""
    return {"sync": multi_turn_session_bench("sync", **kw),
            "async": multi_turn_session_bench("async", **kw)}


def _pinned_flash_policy(_host: int) -> TieringPolicy:
    # thresholds pinned so session KV stays on the flash tier: the
    # benchmark measures the restore path, not placement churn
    return TieringPolicy(tau_hot=1e-12, tau_be=1e-9, ema_alpha=1.0)


def multi_host_session_bench(mode: str = "async", *,
                             n_hosts: Optional[int] = None,
                             n_sessions: int = 16,
                             rounds: int = 2,
                             kv_bytes: int = 1 << 20,
                             decode_steps: int = 16,
                             step_time: float = 2e-3,
                             lead=8,
                             skew: float = 0.0,
                             seed: int = 0,
                             sim_cfg=None, net_model=None,
                             write_shield_depth=None,
                             topology=None,
                             locality: bool = False,
                             churn: Optional[Dict[str, int]] = None,
                             rebalance_rate: Optional[float] = None,
                             spec=None,
                             kv_tier: Tier = Tier.FLASH,
                             device: Optional[Union[str, torch.device]]
                             = None) -> Dict[str, float]:
    """Fleet serving on the sharded fabric's shared virtual clock.

    Each turn resumes one session on one host: restore its KV through
    the fabric (a cross-host NIC + remote-flash composition whenever the
    serving host is not the shard owner), decode `decode_steps` tokens,
    pause (KV streams back to the owner shard). The (session, host)
    schedule is drawn up front from a seeded RNG — identical for both
    modes — with session popularity Zipf-skewed by `skew` (0 = uniform).
    Async mode issues the next turn's restore from the next serving
    host's vantage point, `lead` steps before the current turn ends
    (`lead="p99"` sizes it per turn from the owner flash tail + NIC leg).

    `locality=True` reroutes each turn to the least-loaded host already
    holding the session's KV (the scheduled host is only a fallback),
    turning remote restores into local reads. `churn={"join_turn": t}`
    joins a host before turn t (`"leave_turn"`/`"leave_host"` removes
    one); rebalance streams share the queues with serving traffic, and
    the rebalance tallies land in the returned record.
    `rebalance_rate` caps those streams per source host (bytes/s token
    bucket) so the tax stays bounded under short leads.

    Declarative mode: pass `spec=` (a `repro_torch.platform.HierarchySpec`)
    and the fleet — per-host tier geometry, ring weights, policy, NIC,
    clock — is compiled from it instead of the keyword dialect (the
    fabric-shape kwargs must then stay at their defaults). A
    homogeneous pinned-flash spec reproduces the keyword path
    byte-for-byte. `kv_tier` is the pause/landing ask (FLASH measures
    the restore path; DRAM exercises capacity placement, where a
    capacity-weighted ring keeps big-DRAM hosts loaded proportionally).

    `device` is where a `spec=` fleet's economic gates keep their reuse
    sketch (`Platform.compile(spec, device=device)`: CUDA unless the
    caller asks for the CPU; the record does not depend on it). The
    keyword path's pinned-flash fleet holds nothing on a device, so
    `device` is not used there.
    """
    assert mode in ("sync", "async"), mode
    if spec is not None:
        conflicts = [name for name, v in [
            ("n_hosts", n_hosts), ("sim_cfg", sim_cfg),
            ("net_model", net_model),
            ("write_shield_depth", write_shield_depth),
            ("topology", topology), ("rebalance_rate", rebalance_rate)]
            if v is not None]
        if conflicts:
            raise ValueError(
                f"spec= already declares the fleet; drop the keyword(s) "
                f"{conflicts} or fold them into the spec")
        from ..platform.compiler import Platform
        platform = Platform.compile(spec, device=device)
        clock, fabric = platform.clock, platform.fabric
        n_hosts = fabric.n_hosts
    else:
        n_hosts = 4 if n_hosts is None else n_hosts
        clock = VirtualClock()
        fabric = ShardedTieredStore(
            n_hosts, policy_factory=_pinned_flash_policy, clock=clock,
            sim_cfg=sim_cfg, net_model=net_model,
            write_shield_depth=write_shield_depth, topology=topology,
            rebalance_rate=rebalance_rate)
    blob = np.zeros(max(kv_bytes // 4, 1), np.float32)
    keys = [("kv", f"s{i}") for i in range(n_sessions)]
    for i, k in enumerate(keys):
        fabric.put(k, blob, tier=kv_tier, from_host=i % n_hosts)
    fabric.drain()                      # start from quiesced queues
    fabric.reset_stats()                # measured phase only, not setup
    resident_before = fabric.resident_bytes()

    rng = np.random.default_rng(seed)
    n_turns = rounds * n_sessions
    w = np.power(np.arange(1, n_sessions + 1, dtype=float), -float(skew))
    w /= w.sum()
    sched = [(int(s), int(h)) for s, h in zip(
        rng.choice(n_sessions, size=n_turns, p=w),
        rng.integers(0, n_hosts, size=n_turns))]

    events: Dict[int, list] = {}
    if churn:
        # join before leave at the same turn: the fleet grows, then the
        # newest host departs — both rebalances are measured
        if "join_turn" in churn:
            events.setdefault(int(churn["join_turn"]),
                              []).append(("join", None))
        if "leave_turn" in churn:
            events.setdefault(int(churn["leave_turn"]),
                              []).append(("leave", churn.get("leave_host")))

    def route(si: int, host: int) -> int:
        """Serving host for a turn: locality reroute when enabled, and a
        fallback when the scheduled host has left the fleet."""
        if locality:
            return fabric.preferred_host(keys[si], default=host)
        if host not in fabric.hosts:
            return fabric.preferred_host(keys[si],
                                         default=fabric.host_ids[0])
        return host

    total_stall = 0.0
    tokens = 0
    locality_hits = 0
    pending: Dict[int, tuple] = {}      # turn index -> (handle, host)
    for t, (si, host) in enumerate(sched):
        for action, victim in events.pop(t, ()):
            if action == "join":
                fabric.add_host()
            elif fabric.n_hosts > 1:
                victim = max(fabric.host_ids) if victim is None else victim
                fabric.remove_host(victim)
                pending = {k: v for k, v in pending.items()
                           if v[1] in fabric.hosts}
        key = keys[si]
        # --- restore -----------------------------------------------------
        t0 = clock.now()
        entry = pending.pop(t, None)
        pf, host = entry if entry is not None else (None, route(si, host))
        if fabric.hosts[host].tier_of(key) is not None:
            locality_hits += 1
        if pf is None:
            pf = fabric.get_async(key, from_host=host)
        pf.wait()
        total_stall += clock.now() - t0
        # --- decode, issuing the next turn's prefetch mid-turn -----------
        prefetch_at = decode_steps
        nxt = None
        if mode == "async" and t + 1 < n_turns and t + 1 not in pending:
            nsi, nhost = sched[t + 1]
            nhost = route(nsi, nhost)
            if fabric.tier_of(keys[nsi]) is not None:
                nxt = (nsi, nhost)
                prefetch_at = max(0, decode_steps - _lead_steps(
                    lead, fabric, keys[nsi], step_time, decode_steps,
                    from_host=nhost))
        for s in range(decode_steps):
            if s == prefetch_at and nxt is not None:
                nsi, nhost = nxt
                pending[t + 1] = (fabric.get_async(
                    keys[nsi], from_host=nhost), nhost)
            clock.advance(step_time)
        tokens += decode_steps
        # --- pause (KV streams back to the owner shard) -------------------
        fabric.put(key, blob, tier=kv_tier, from_host=host)

    s = fabric.summary()
    out = {
        "mode": mode,
        "hosts": float(n_hosts),
        "final_hosts": float(fabric.n_hosts),
        "skew": float(skew),
        "locality": float(locality),
        "locality_hits": float(locality_hits),
        "tokens": float(tokens),
        "total_stall": total_stall,
        "per_token_stall": total_stall / max(tokens, 1),
        "makespan": clock.now(),
        "resident_bytes": float(resident_before),
    }
    for k in ("local_fetches", "remote_fetches", "remote_puts",
              "prefetch_hits", "prefetch_late", "demotions_deferred",
              "nic_stall", "nic_bytes", "rebalances",
              "rebalance_keys_moved", "rebalance_bytes_moved"):
        out[k] = s[k]
    if fabric.rebalances:
        out["rebalance_events"] = [rb.as_dict()
                                   for rb in fabric.rebalances]
    return out


def compare_fleet(**kw) -> Dict[str, object]:
    """Both modes on the identical fleet schedule, plus the stall ratio
    (sync per-token stall over async — the prefetch win at fleet scale)."""
    sync = multi_host_session_bench("sync", **kw)
    async_ = multi_host_session_bench("async", **kw)
    speedup = sync["per_token_stall"] / max(async_["per_token_stall"],
                                            1e-12)
    return {"sync": sync, "async": async_, "stall_speedup": speedup}


def compare_churn(churn: Dict[str, int], *, baseline=None,
                  **kw) -> Dict[str, object]:
    """The rebalance tax, measured: the identical async schedule with and
    without the churn events, plus the added per-token stall and the
    moved-fraction of resident bytes (on a 4->5 join this should sit
    near 1/5 — the consistent-hash promise). Pass `baseline=` when the
    no-churn async record for these kwargs already exists (runs are
    byte-identical, so re-simulating it would only burn time)."""
    if baseline is None:
        baseline = multi_host_session_bench("async", **kw)
    churned = multi_host_session_bench("async", churn=churn, **kw)
    added = (churned["per_token_stall"] - baseline["per_token_stall"])
    return {
        "baseline": baseline,
        "churn": churned,
        "added_stall_per_token": added,
        "stall_ratio": (churned["per_token_stall"]
                        / max(baseline["per_token_stall"], 1e-12)),
        "rebalance_bytes": churned["rebalance_bytes_moved"],
        "rebalance_fraction": (churned["rebalance_bytes_moved"]
                               / max(churned["resident_bytes"], 1)),
    }
