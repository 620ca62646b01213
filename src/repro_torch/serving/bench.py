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

The fleet benchmarks of the reference (`multi_host_session_bench`,
`compare_churn`) and its scale replay wait for ROADMAP Queue 1 item 7;
the continuous scheduler is `serving.scheduler`.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from ..core.policy import Tier, TieringPolicy
from ..runtime.clock import VirtualClock
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
