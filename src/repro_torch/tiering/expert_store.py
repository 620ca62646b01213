"""MoE expert-weight tiering — the textbook instance of the paper's rule.

Expert weights have wildly skewed reuse intervals at inference (router
popularity is long-tailed); the five-second rule says: keep an expert in
fast memory iff its observed reuse interval is below the calibrated
break-even threshold. Cold experts live on the flash tier and are
streamed on demand.

`ExpertStore` tracks per-expert selection counts from router outputs,
converts them to reuse intervals, and maintains residency through the
shared TieredStore. `residency_plan` also answers the provisioning
question: how much HBM/DRAM do we need for a target hit rate.

Expert streaming rides the same async movement engine as serving KV:
`prefetch_experts` issues non-blocking fetches for the experts the
router just selected for the *next* layer/step, and `fetch_expert`
blocks only on the unfinished remainder — cold-expert flash reads
overlap with the current layer's compute, with queueing-aware service
times from the calibrated ssdsim model. `decode_step` wires the two
into the MoE decode path: layer L's router output triggers layer L+1's
prefetch one layer of compute ahead, and every routing feeds the
placement policy — with an `autopilot.gate.EconomicGate` that is the
break-even admission loop for expert weights.

Fleet mode: pass `store=fabric.host_view(host, replicas=r)` (what
`repro_torch.platform.Platform.expert_store` does) to shard replicated cold
experts over the multi-host fabric — each expert lives on its
`replicas` consistent-hash owner hosts, a selection served by a
co-resident replica is a local flash read, and the rest stream over the
NIC transfer tier composed with the remote host's flash. The old
`fabric=`/`host=`/`replicas=` constructor dialect still works as a thin
deprecated shim.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, Optional

import numpy as np

from ..core.policy import Tier, TieringPolicy
from ..runtime.tiers import PendingFetch, TieredStore


class ExpertStore:
    def __init__(self, n_layers: int, n_experts: int,
                 policy: TieringPolicy, store: Optional[TieredStore] = None,
                 fabric=None, host: int = 0, replicas: int = 1,
                 expert_bytes: float = 0.0, clock=None):
        self.n_layers = n_layers
        self.n_experts = n_experts
        self.policy = policy
        if store is None and fabric is not None:
            # legacy constructor dialect — the declarative path is
            # Platform.expert_store(...) / a fabric host view
            warnings.warn(
                "ExpertStore(fabric=..., host=..., replicas=...) is "
                "deprecated; compile a repro_torch.platform.HierarchySpec "
                "and use Platform.expert_store(...), or pass "
                "store=fabric.host_view(host, replicas=...)",
                DeprecationWarning, stacklevel=2)
            store = fabric.host_view(host, replicas=replicas)
        elif store is not None:
            # a fabric host view carries its own host identity
            host = getattr(store, "host", host)
        self.host = host
        self.store = store or TieredStore(policy, clock=clock)
        self.clock = self.store.clock
        self._pending: Dict[tuple, PendingFetch] = {}
        self.expert_bytes = expert_bytes
        self.counts = np.zeros((n_layers, n_experts), np.int64)
        self.steps = 0
        self.tokens_per_step = 0

    # ------------------------------------------------------------- tracking
    def observe_routing(self, layer: int, expert_ids: np.ndarray,
                        now: float):
        """Feed one layer's router output (any shape of int expert ids)."""
        ids, cnt = np.unique(np.asarray(expert_ids).ravel(),
                             return_counts=True)
        self.counts[layer, ids] += cnt
        for e in ids:
            self.policy.observe((layer, int(e)), now=now)

    def observe_step(self, routings: Dict[int, np.ndarray], now: float,
                     tokens: int):
        self.steps += 1
        self.tokens_per_step = tokens
        for layer, ids in routings.items():
            self.observe_routing(layer, ids, now)

    # ------------------------------------------------------------ decisions
    def reuse_intervals(self, step_time: float) -> np.ndarray:
        """Expected per-expert reuse interval from empirical popularity:
        tau_e = step_time / P(expert selected in a step)."""
        total = max(self.steps, 1)
        p = np.clip(self.counts / max(
            total * max(self.tokens_per_step, 1), 1), 1e-12, 1.0)
        p_step = 1.0 - np.power(1.0 - p, max(self.tokens_per_step, 1))
        return step_time / np.clip(p_step, 1e-12, 1.0)

    def residency_plan(self, step_time: float) -> Dict[str, object]:
        """Tier per expert via the stateless rule + capacity summary."""
        tau = self.reuse_intervals(step_time)
        tiers = np.asarray(self.policy.tiers_for_intervals(tau))
        plan = {
            "hbm_experts": int((tiers == Tier.HBM).sum()),
            "dram_experts": int((tiers == Tier.DRAM).sum()),
            "flash_experts": int((tiers == Tier.FLASH).sum()),
            "tiers": tiers,
        }
        if self.expert_bytes:
            plan["hbm_bytes"] = plan["hbm_experts"] * self.expert_bytes
            plan["dram_bytes"] = plan["dram_experts"] * self.expert_bytes
        return plan

    def apply_plan(self, weights: Dict, step_time: float):
        """Move actual expert weight blobs between tiers per the plan
        (movement is queued on the async runtime — it streams behind
        compute rather than blocking the step)."""
        plan = self.residency_plan(step_time)
        tiers = plan["tiers"]
        for (layer, e), blob in weights.items():
            want = Tier(int(tiers[layer, e]))
            cur = self.store.tier_of((layer, e))
            if cur is None:
                self.store.put((layer, e), blob, tier=want)
            elif cur != want:
                self.store.move((layer, e), want)
        return plan

    # ------------------------------------------------------------ routing
    def locality_host(self, layer: int, expert: int) -> int:
        """Host a selection of this expert should be routed to: one
        already holding a replica (the stream becomes a local flash
        read), else this store's host. Single-host stores are their own
        locality."""
        fab = getattr(self.store, "fabric", None)
        if fab is None:
            return self.host
        return fab.preferred_host((layer, int(expert)), default=self.host)

    def prefetch_lead_steps(self, layer: int, expert: int,
                            step_time: float) -> int:
        """p99-sized prefetch lead for this expert in decode steps (how
        early `prefetch_experts` should run so the tail-aware fetch
        estimate is covered); 1 when the store predates lead sizing."""
        lead_fn = getattr(self.store, "prefetch_lead_steps", None)
        if lead_fn is None or step_time <= 0:
            return 1
        return lead_fn((layer, int(expert)), step_time)

    # ------------------------------------------------------------ streaming
    def prefetch_experts(self, layer: int, expert_ids) -> int:
        """Issue async fetches for `expert_ids` of `layer`; returns how
        many fetches were actually started (resident-pending ones skip)."""
        started = 0
        for e in np.unique(np.asarray(expert_ids).ravel()):
            key = (layer, int(e))
            if key in self._pending or self.store.tier_of(key) is None:
                continue
            self._pending[key] = self.store.get_async(key)
            started += 1
        return started

    def fetch_expert(self, layer: int, expert: int) -> np.ndarray:
        """Blocking access to one expert's weights; only the unfinished
        part of a prior prefetch stalls."""
        key = (layer, int(expert))
        pf = self._pending.pop(key, None)
        if pf is None:
            pf = self.store.get_async(key)
        return pf.wait()

    # ----------------------------------------------------- decode pipeline
    def decode_step(self, routings: Dict[int, np.ndarray], *,
                    layer_time: float, tokens: int = 1) -> Dict[str, float]:
        """One modeled MoE decode step with layer-pipelined expert
        streaming: when layer L's router output lands, the experts layer
        L+1 selects are prefetched *before* L's own (blocking) fetches
        and L's compute, so each cold-expert flash read overlaps a full
        layer of compute instead of stalling its own layer.

        `routings` maps layer -> router-selected expert ids for this
        step (from the model's routers, a router trace, or a lookahead
        predictor). Every routing is also observed by the policy — with
        an `EconomicGate` this is what feeds the reuse sketch, so cold
        experts earn DRAM residency exactly when their measured reuse
        clears break-even. The first layer has no upstream to hide
        behind; its unprefetched fetches stall (unless a previous step
        left them resident in a fast tier).

        Returns modeled totals: decode-visible stall, fetches issued,
        prefetches started."""
        self.steps += 1
        self.tokens_per_step = tokens
        stall = 0.0
        fetched = 0
        prefetched = 0
        layers = sorted(routings)
        for i, layer in enumerate(layers):
            # raw routing keeps per-token multiplicity for the
            # popularity counts; the fetch loop below dedups itself
            self.observe_routing(layer, routings[layer],
                                 now=self.clock.now())
            ids = np.unique(np.asarray(routings[layer]).ravel())
            if i + 1 < len(layers):
                prefetched += self.prefetch_experts(
                    layers[i + 1], routings[layers[i + 1]])
            for e in ids:
                if self.store.tier_of((layer, int(e))) is None:
                    continue            # expert not materialized here
                t0 = self.clock.now()
                self.fetch_expert(layer, int(e))
                stall += self.clock.now() - t0
                fetched += 1
            self.store.runtime.advance(layer_time)
        return {"stall": stall, "fetched": float(fetched),
                "prefetched": float(prefetched)}
