"""ShardedTieredStore — the multi-host tiering fabric (scale-out of the
paper's five-second rule to fleet serving).

The hot set S(T) of millions of sessions does not fit one host: keys are
sharded by consistent hashing over N per-host `TieredStore` instances,
each with its own `AsyncTierRuntime` and HBM/DRAM/flash queues, so
queueing on one host's Storage-Next SSD never perturbs another's. All
hosts — and every per-host NIC lane — are driven by ONE shared clock
(deterministic `VirtualClock` under test): a single `advance` models
compute on the serving host while transfers stream concurrently on
every host's flash and NIC queues, which is what makes cross-host
prefetch overlap simulable and byte-reproducible.

Network-tier service model: each host owns a NIC lane (an
`AsyncTierRuntime` whose only service model is `NetQueueModel`) with the
same occupancy/latency split as the flash tier — occupancy is the wire
time at the bandwidth share the link sustains at the current in-flight
depth (a single window-limited stream cannot saturate it), latency is
the fixed cluster RTT. Occupancies serialize on the lane, RTTs pipeline.
A remote fetch *composes* the two tiers: the owner host's flash read is
issued normally, and the NIC transfer is issued in the same instant but
gated with `not_before=flash.done_t` — it occupies a NIC queue slot
immediately (depth-dependent bandwidth share, FIFO link order) yet
cannot put bytes on the wire before the flash read delivers them. Data
always crosses the *sender's* egress NIC: the owner's for fetches, the
writing host's for cross-host puts.

Topology mode: pass `topology=FabricTopology(...)` (or a `net_model`
with one attached) and the single uniform link becomes per-pair — an
intra-rack hop gets the short ToR RTT at full NIC bandwidth, a
cross-rack hop the longer spine RTT at the oversubscribed uplink share,
and high fan-in into one destination divides its ingress bandwidth (the
incast penalty). The fabric tracks in-flight flows per destination and
hands the model `src`/`dst`/`fan_in` on every NIC submit.

Elasticity: `add_host()` / `remove_host(h)` recompute the consistent-
hash ring (vnodes keep the remap at ~1/N of resident keys) and stream
only the remapped keys as background rebalance transfers on the shared
clock — a flash read on a current holder, the sender's egress NIC
(gated on the read), and a destination placement whose write charge is
subject to the destination's write shielding exactly like a demotion.
Each call returns a `RebalanceStats` (keys/bytes moved vs resident) so
benchmarks can price the rebalance tax in stall per token; serving
continues throughout, it only queues behind the rebalance traffic.
`rebalance_rate=` caps the streams with a per-source token bucket
(bytes/s): each stream's flash read is released only after the bucket
drains the previous streams, bounding the tax under short prefetch
leads. Mid-rebalance restores at the destination are priced
conservatively: the destination store gates reads of a streamed key on
its NIC delivery time (readability gating, see `TieredStore.ingest`).

Unplanned failure: `fail_host(h)` is `remove_host` without the
courtesy — no drain, no retired queues. Keys resident only on h are
lost; replicated keys survive and reads route around the dead holder
(`holders()` only ever lists active hosts — degraded reads need no
special path), with `RemoteFetch.wait()` falling back to a surviving
holder when the sender died mid-flight. `under_replicated()` lists the
keys whose copy set no longer matches their target placement, and the
repair loop (`runtime/repair.py`) streams them back to their declared
degree under the rebalance pacer.

Admission control rides in from `TieredStore`: pass
`write_shield_depth=k` and each host defers demotion writes while its
flash tier has >= k fetches in flight (Flashield-style write shielding;
deferral stats in each host's `TierStats`).

Replication: `put(..., replicas=r)` places copies on the r distinct
ring-successor hosts, and `get_async(..., from_host=h)` serves from h
itself when it holds a replica (no network), else from the first
replica in ring order, so a popular replicated key is usually a local
flash read. The requested
`r` is remembered per key, so rebalancing after a join can restore a
replication degree the old host count could not hold.

Locality-aware scheduling: `preferred_host(key)` answers "where should
this session resume / this expert be fetched" — the least-loaded
current holder (resident-tier + NIC queue depth, ties in ring order),
which turns the remote NIC + remote-flash composition into a plain
local read and spreads hot replicated keys across their holders.
`prefetch_lead_steps` sizes the prefetch lead from the owner flash
tier's calibrated open-loop p99 (plus the NIC leg for remote fetches)
instead of a fixed step count.

Heterogeneous hosts: pass `host_specs=[{Tier: TierSpec, ...}, ...]`
(one entry per host; None entries take the shared default) and
`weights=[...]` and each host gets its own tier capacities/bandwidths
while the consistent-hash ring places `round(vnodes * weight)` virtual
nodes per host — a host with twice the capacity weight owns ~twice the
keys. Equal weights reproduce the unweighted ring bit-for-bit (the same
`host{h}/vn{v}` points), so homogeneous fleets are unchanged.
`add_host(specs=, weight=)` extends an elastic fleet with a
non-template host. The declarative front door for all of this is
`repro_torch.platform.HierarchySpec` -> `Platform.compile`.
"""
from __future__ import annotations

import bisect
import dataclasses
import hashlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.policy import Tier, TieringPolicy
from ..obs.ledger import StallLedger
from .async_engine import AsyncTierRuntime, Transfer
from .clock import ensure_clock
from .pool import PooledFetch, PooledStore
from .service import NetQueueModel
from .tiers import (PendingFetch, TierSpec, TieredStore,
                    lead_steps_from_estimate)

NIC = "NIC"                     # lane key on each host's NIC runtime


def _key_digest(data: bytes) -> int:
    return int.from_bytes(
        hashlib.blake2b(data, digest_size=8).digest(), "big")


@dataclasses.dataclass
class RemoteFetch:
    """Handle for a cross-host fetch: the owner host's flash/DRAM read
    composed with the NIC transfer that starts when the read is done.
    `wait()` yields the value after blocking on the *unfinished* part of
    both stages — zero stall when enough compute overlapped.

    Degraded reads under unplanned failure: a *retired* owner
    (`remove_host`) keeps its queues alive until in-flight egress
    resolves, but a *failed* owner (`fail_host`) vanishes with the bytes
    still on the wire. `wait()` then falls back to a fresh fetch from a
    surviving holder — paying that full fetch as stall — or raises
    `KeyError` when the key died with the host."""
    fabric: "ShardedTieredStore"
    pf: PendingFetch
    nic_tr: Transfer
    owner: int
    dst: int = 0

    def _owner_failed_in_flight(self) -> bool:
        t_fail = self.fabric.failed.get(self.owner)
        return t_fail is not None and self.nic_tr.done_t > t_fail + 1e-12

    def done(self) -> bool:
        if self._owner_failed_in_flight():
            return False
        return self.nic_tr.is_done(self.fabric.clock.now())

    def wait(self) -> np.ndarray:
        if self._owner_failed_in_flight():
            # the sender died before delivery: degraded re-read from a
            # surviving holder (raises KeyError when the key was lost)
            fab = self.fabric
            if fab.obs is not None and fab.obs.tracer is not None:
                t = fab.obs.tracer
                t.instant(t.track("fabric", "failures"), "degraded_read",
                          fab.clock.now(), cat="policy",
                          args={"key": str(self.pf.key),
                                "dead_owner": self.owner,
                                "dst": self.dst})
            if fab.obs is not None and fab.obs.metrics is not None:
                fab.obs.metrics.counter("degraded_reads").inc(
                    (f"host{self.dst}",))
            return fab.get(self.pf.key, from_host=self.dst)
        if self.owner in self.fabric.failed:
            # both legs delivered before the failure instant; the dead
            # host's queues are gone, so skip its bookkeeping entirely
            return self.pf.value
        value = self.pf.wait()          # owner-store stats + policy move
        # the owner may have left the fleet since issue; its NIC lane
        # lives on in the retired map until the transfer resolves
        self.fabric._nic_of(self.owner).wait(self.nic_tr)
        return value


@dataclasses.dataclass
class FailureReport:
    """One unplanned host failure: what died with the host.

    `keys_lost` counts keys whose only copy lived on the failed host
    (committed data gone — their values and `_key_replicas` bookkeeping
    are purged, and `on_key_loss` subscribers fire). `keys_degraded`
    counts keys that survive on a replica but now sit below their
    declared replication degree until the repair loop restores it."""
    host: int
    t_fail: float
    keys_resident: int = 0      # keys the host held at the instant
    keys_lost: int = 0          # only copy was on the host
    bytes_lost: int = 0
    keys_degraded: int = 0      # survive on a replica, under-replicated
    lost_keys: Tuple = ()

    def as_dict(self) -> Dict[str, float]:
        return {
            "host": float(self.host),
            "t_fail": float(self.t_fail),
            "keys_resident": float(self.keys_resident),
            "keys_lost": float(self.keys_lost),
            "bytes_lost": float(self.bytes_lost),
            "keys_degraded": float(self.keys_degraded),
        }


@dataclasses.dataclass
class RebalanceStats:
    """One host join/leave: what the elastic remap actually moved.

    `bytes_resident` counts one copy per resident key at rebalance time
    (the fleet's unique payload), `bytes_moved` the rebalance streams —
    on a join of host N+1 their ratio should sit near 1/(N+1), the
    consistent-hash promise, measured rather than assumed. The stall tax
    is *not* in here: it lands in the ordinary tier/NIC queue stats of
    whatever serving traffic ran concurrently, and benchmarks price it
    as (churn stall - baseline stall) per token."""
    action: str                 # "join" | "leave"
    host: int                   # host id that joined / left
    t_start: float
    keys_resident: int = 0
    bytes_resident: int = 0
    keys_moved: int = 0
    bytes_moved: int = 0
    nic_transfers: int = 0

    @property
    def moved_fraction(self) -> float:
        return self.bytes_moved / max(self.bytes_resident, 1)

    def as_dict(self) -> Dict[str, float]:
        return {
            "action": self.action,
            "host": float(self.host),
            "t_start": float(self.t_start),
            "keys_resident": float(self.keys_resident),
            "bytes_resident": float(self.bytes_resident),
            "keys_moved": float(self.keys_moved),
            "bytes_moved": float(self.bytes_moved),
            "nic_transfers": float(self.nic_transfers),
            "moved_fraction": float(self.moved_fraction),
        }


class HostView:
    """One host's façade over the fabric, duck-typing `TieredStore` so
    `DecodeEngine` runs unmodified: every access routes
    through the fabric with this host as `from_host` (and this view's
    replication factor for puts)."""

    def __init__(self, fabric: "ShardedTieredStore", host: int,
                 replicas: int = 1):
        self.fabric = fabric
        self.host = host
        self.replicas = replicas

    @property
    def clock(self):
        return self.fabric.clock

    @property
    def runtime(self) -> AsyncTierRuntime:
        return self.fabric.hosts[self.host].runtime

    @property
    def stats(self):
        return self.fabric.hosts[self.host].stats

    @property
    def obs(self):
        return self.fabric.obs

    @property
    def ledger(self):
        return self.fabric.ledger

    @property
    def label(self) -> str:
        return f"host{self.host}"

    def put(self, key, value, tier: Tier = Tier.DRAM):
        self.fabric.put(key, value, tier=tier, from_host=self.host,
                        replicas=self.replicas)

    def get(self, key):
        return self.fabric.get(key, from_host=self.host)

    def get_async(self, key):
        return self.fabric.get_async(key, from_host=self.host)

    def tier_of(self, key) -> Optional[Tier]:
        return self.fabric.tier_of(key)

    def move(self, key, dst: Tier):
        self.fabric.move(key, dst)

    def delete(self, key):
        self.fabric.delete(key)

    def estimate_fetch_seconds(self, key) -> float:
        return self.fabric.estimate_fetch_seconds(key,
                                                  from_host=self.host)

    def prefetch_lead_steps(self, key, step_time: float) -> int:
        return self.fabric.prefetch_lead_steps(key, step_time,
                                               from_host=self.host)


class ShardedTieredStore:
    """Consistent-hash-sharded multi-host TieredStore on one clock,
    elastic under host join/leave."""

    def __init__(self, n_hosts: Optional[int] = None, *,
                 policy_factory=None,
                 specs: Optional[Dict[Tier, TierSpec]] = None,
                 host_specs: Optional[
                     List[Optional[Dict[Tier, TierSpec]]]] = None,
                 weights: Optional[List[float]] = None,
                 clock=None, sim_cfg=None,
                 net_model: Optional[NetQueueModel] = None,
                 write_shield_depth: Optional[int] = None,
                 vnodes: int = 64, topology=None,
                 rebalance_rate: Optional[float] = None,
                 obs=None, pool: Optional[PooledStore] = None):
        if host_specs is not None:
            if n_hosts is not None and n_hosts != len(host_specs):
                raise ValueError(
                    f"n_hosts={n_hosts} but {len(host_specs)} host_specs "
                    f"given; pass one or make them agree")
            n_hosts = len(host_specs)
        if n_hosts is None or n_hosts < 1:
            raise ValueError("need at least one host")
        if weights is not None:
            if len(weights) != n_hosts:
                raise ValueError(
                    f"{len(weights)} ring weights for {n_hosts} hosts")
            if any(w <= 0 for w in weights):
                raise ValueError("ring weights must be positive")
        if rebalance_rate is not None and rebalance_rate <= 0:
            raise ValueError("rebalance_rate must be positive bytes/s")
        self.clock = ensure_clock(clock)
        if policy_factory is None:
            policy_factory = lambda h: TieringPolicy(  # noqa: E731
                tau_hot=0.05, tau_be=5.0)
        # construction recipe, reused verbatim by add_host()
        self._policy_factory = policy_factory
        self._specs = specs
        self._sim_cfg = sim_cfg
        self._write_shield_depth = write_shield_depth
        self.vnodes = vnodes
        # token-bucket cap on rebalance streams, bytes/s per source host
        # (None = stream at full rate, the pre-pacing behavior)
        self.rebalance_rate = rebalance_rate
        if net_model is None:
            net_model = NetQueueModel(topology=topology)
        elif topology is not None:
            # ambiguous: the model's own topology (even None) would
            # silently win over the explicit argument
            raise ValueError(
                "pass the topology on the net_model, not alongside it")
        self.net_model = net_model
        # one observability plane (and ONE stall ledger) shared by every
        # host runtime and NIC lane — cross-host stall lands in the same
        # conservation-checked ledger as local stall
        self.obs = obs
        self.ledger: StallLedger = (obs.ledger if obs is not None
                                    else StallLedger())
        # the fleet-shared far-memory pool (None = the 3-tier fleet):
        # lanes attach per host in _new_host, capacity pressure spills
        # back to the owner's flash, and failure semantics are split —
        # the pool survives fail_host, the host's lane does not
        self.pool = pool
        if pool is not None:
            pool.on_evict = self._pool_evict
        self.hosts: Dict[int, TieredStore] = {}
        self.nic: Dict[int, AsyncTierRuntime] = {}
        self.host_ids: List[int] = []
        self._next_host = 0
        # per-host tier specs and ring weight (heterogeneous fleets);
        # a None spec entry means "the shared default"
        self._host_specs: Dict[int, Optional[Dict[Tier, TierSpec]]] = {}
        self._weights: Dict[int, float] = {}
        for i in range(n_hosts):
            self._new_host(
                specs=host_specs[i] if host_specs is not None else None,
                weight=weights[i] if weights is not None else 1.0)
        self._rebuild_ring()
        # in-flight NIC flows (transfer, src, dst) — destination fan-in
        # for the topology model's incast penalty
        self._nic_flows: List[Tuple[Transfer, int, int]] = []
        # requested replication degree per key (pre-clamp, so a join can
        # restore a degree the old host count could not hold)
        self._key_replicas: Dict[object, int] = {}
        # hosts removed but still carrying queue history (and possibly
        # in-flight egress) for drain/stats and late RemoteFetch waits
        self.retired: Dict[int, Tuple[TieredStore, AsyncTierRuntime]] = {}
        # hosts lost to unplanned failure: host -> failure time. Unlike
        # retirement nothing survives — in-flight egress is dead and
        # RemoteFetch handles fall back to a surviving holder.
        self.failed: Dict[int, float] = {}
        self.failures: List[FailureReport] = []
        # subscriber for lost keys (fabric-external bookkeeping: session
        # tables, benchmarks); per-host policies with a `forget_keys`
        # hook are notified regardless
        self.on_key_loss = None
        self.rebalances: List[RebalanceStats] = []
        # fabric-level counters
        self.local_fetches = 0
        self.remote_fetches = 0
        self.remote_puts = 0
        self.pool_fetches = 0
        self.pool_puts = 0

    @property
    def n_hosts(self) -> int:
        return len(self.host_ids)

    # ------------------------------------------------------------- topology
    def _new_host(self, specs: Optional[Dict[Tier, TierSpec]] = None,
                  weight: float = 1.0) -> int:
        if weight <= 0:
            raise ValueError("ring weight must be positive")
        h = self._next_host
        self._next_host += 1
        self._host_specs[h] = specs
        self._weights[h] = float(weight)
        self.hosts[h] = TieredStore(
            self._policy_factory(h),
            specs=specs if specs is not None else self._specs,
            clock=self.clock, sim_cfg=self._sim_cfg,
            write_shield_depth=self._write_shield_depth,
            obs=self.obs, ledger=self.ledger, label=f"host{h}")
        self.nic[h] = AsyncTierRuntime(
            clock=self.clock, service_models={NIC: self.net_model},
            obs=self.obs, ledger=self.ledger, label=f"host{h}")
        # attach the gate's decision tracer (policy instants ride on the
        # same tracer as the transfer spans)
        policy = self.hosts[h].policy
        if hasattr(policy, "obs"):
            policy.obs = self.obs
        if self.pool is not None:
            self.pool.attach_host(h)
        self.host_ids.append(h)
        return h

    def _rebuild_ring(self):
        # consistent-hash ring: `round(vnodes * weight)` points per host
        # keep the key split proportional to capacity weight (uniform
        # weights: exactly `vnodes` each — the unweighted ring bit-for-
        # bit) and make host count changes remap only ~weight/total keys
        points: List[Tuple[int, int]] = []
        for h in self.host_ids:
            n_pts = max(1, int(round(self.vnodes * self._weights[h])))
            for v in range(n_pts):
                points.append((_key_digest(f"host{h}/vn{v}".encode()), h))
        points.sort()
        self._ring_points = [p for p, _ in points]
        self._ring_hosts = [h for _, h in points]
        # array mirror of the ring for the batched control plane:
        # `owner_batch` searchsorts the uint64 point array instead of
        # bisecting per key (the digest covers the full uint64 range, so
        # the dtype is exact for every blake2b-8 point)
        self._ring_points_arr = np.asarray(self._ring_points, np.uint64)
        self._ring_hosts_arr = np.asarray(self._ring_hosts, np.int64)

    def _nic_of(self, host: int) -> AsyncTierRuntime:
        if host in self.nic:
            return self.nic[host]
        return self.retired[host][1]

    def _all_stores(self) -> List[TieredStore]:
        """Active then retired stores — every surface that aggregates or
        drains must include retired hosts until their queues resolve."""
        return list(self.hosts.values()) + [s for s, _ in
                                            self.retired.values()]

    def _all_nics(self) -> List[AsyncTierRuntime]:
        return list(self.nic.values()) + [n for _, n in
                                          self.retired.values()]

    def _nic_submit(self, src: int, dst: int, key, nbytes: int,
                    kind: str, not_before=None) -> Transfer:
        """Egress-NIC submit with per-pair topology context: the model is
        handed src/dst (rack vs spine RTT and bandwidth) and the
        destination's live sender fan-in (incast). Uniform models get the
        plain depth-only call."""
        ctx = None
        incast_frac = 0.0
        if self.net_model.topology is not None:
            now = self.clock.now()
            self._nic_flows = [f for f in self._nic_flows
                               if not f[0].is_done(now)]
            senders = {s for t, s, d in self._nic_flows if d == dst}
            senders.add(src)
            ctx = {"src": src, "dst": dst, "fan_in": len(senders)}
            if len(senders) > 1:
                # the share of this transfer's service the incast
                # penalty is responsible for: compare against the same
                # hop at fan_in=1 (the ledger splits the service window
                # into `incast` vs `nic_queue` by this fraction)
                d = self.nic[src].queue_depth(NIC) + 1
                act = self.net_model.service(nbytes, d, **ctx)
                base = self.net_model.service(nbytes, d, src=src,
                                              dst=dst, fan_in=1)
                if act.total > 0:
                    incast_frac = max(0.0, 1.0 - base.total / act.total)
        tr = self.nic[src].submit(NIC, key, nbytes, kind=kind,
                                  not_before=not_before, ctx=ctx)
        tr.incast_frac = incast_frac
        if self.net_model.topology is not None:
            self._nic_flows.append((tr, src, dst))
        return tr

    def _policy_instant(self, name: str, args: Dict) -> None:
        """Fleet-level policy decision (join/leave/fail/rebalance) onto
        the shared tracer's fabric track."""
        if self.obs is not None and self.obs.tracer is not None:
            t = self.obs.tracer
            t.instant(t.track("fabric", "policy"), name,
                      self.clock.now(), cat="policy", args=args)

    # ------------------------------------------------------------- routing
    def _key_point(self, key) -> int:
        return _key_digest(repr(key).encode())

    def owner(self, key) -> int:
        return self.ring_hosts(key)[0]

    def key_digest_batch(self, keys) -> np.ndarray:
        """uint64 ring digests for a key batch. Hashing is the only
        per-key Python left on the batched routing path; reuse the
        returned digests across calls (`owner_batch(digests=...)`) when
        the key set is stable."""
        return np.fromiter(
            (_key_digest(repr(k).encode()) for k in keys),
            dtype=np.uint64, count=len(keys))

    def owner_batch(self, keys=None, *,
                    digests: Optional[np.ndarray] = None) -> np.ndarray:
        """First ring owner for a batch of keys in one `searchsorted` —
        the vectorized twin of `owner()` (same blake2b points, same
        `bisect_right` wrap semantics), for control planes routing 1e5+
        keys per step. Pass precomputed `digests` (from
        `key_digest_batch`) to amortize hashing across steps; host-count
        changes only rebuild the ring arrays, digests stay valid."""
        if digests is None:
            if keys is None:
                raise ValueError("owner_batch needs keys or digests")
            digests = self.key_digest_batch(keys)
        idx = np.searchsorted(self._ring_points_arr,
                              np.asarray(digests, np.uint64),
                              side="right")
        return self._ring_hosts_arr[idx % len(self._ring_hosts_arr)]

    def ring_hosts(self, key) -> List[int]:
        """All active hosts in ring order starting at the key's point
        (distinct, length n_hosts) — replica placement and
        fetch-preference order."""
        i = bisect.bisect_right(self._ring_points, self._key_point(key))
        seen: List[int] = []
        n = len(self._ring_hosts)
        for j in range(n):
            h = self._ring_hosts[(i + j) % n]
            if h not in seen:
                seen.append(h)
                if len(seen) == self.n_hosts:
                    break
        return seen

    def holders(self, key) -> List[int]:
        """Hosts currently holding `key`, in ring-preference order."""
        return [h for h in self.ring_hosts(key)
                if self.hosts[h].tier_of(key) is not None]

    def preferred_host(self, key,
                       default: Optional[int] = None) -> Optional[int]:
        """Locality-aware, replica-aware routing: the *least-loaded*
        current holder — serving there turns the remote NIC +
        remote-flash composition into a local read, and with replicas
        the read load spreads by live queue depth (the holder's resident
        tier plus its NIC lane) instead of always hammering the first
        ring owner. Ties break in ring order, so the single-replica
        behavior is unchanged. Returns `default` when nothing holds the
        key."""
        held = self.holders(key)
        if len(held) <= 1:
            return held[0] if held else default

        def load(pos_host):
            pos, h = pos_host
            store = self.hosts[h]
            depth = store.runtime.queue_depth(store.tier_of(key))
            return (depth + self.nic[h].queue_depth(NIC), pos)

        return min(enumerate(held), key=load)[1]

    def _targets(self, key) -> List[int]:
        r = self._key_replicas.get(key, 1)
        return self.ring_hosts(key)[:max(1, min(r, self.n_hosts))]

    # ------------------------------------------------------------------ api
    def put(self, key, value, tier: Tier = Tier.DRAM, from_host: int = 0,
            replicas: int = 1):
        """Place `key` on its `replicas` ring-owner hosts. A copy bound
        for a host other than `from_host` additionally streams over the
        writer's egress NIC (non-blocking, like tier writes)."""
        value = np.asarray(value)
        self._key_replicas[key] = max(1, int(replicas))
        if self._pool_admit(key, tier, from_host):
            # the gate priced the object into the pool: one fleet copy
            # behind the writer's pool lane, no per-host residency (the
            # pool is infrastructure — host replication does not apply)
            for h in self.holders(key):
                self.hosts[h].delete(key)
            self.pool.put(key, value, from_host=from_host)
            self.pool_puts += 1
            # same admit-then-observe order as TieredStore.put: the
            # write is a reuse event even though no host placed bytes
            self.hosts[from_host].policy.observe(
                key, now=self.clock.now())
            return
        targets = self._targets(key)
        # drop stale copies on hosts that are no longer targets
        for h in self.holders(key):
            if h not in targets:
                self.hosts[h].delete(key)
        for h in targets:
            self.hosts[h].put(key, value, tier=tier)
            if h != from_host:
                self._nic_submit(from_host, h, key, value.nbytes,
                                 kind="write")
                self.remote_puts += 1
        if self.pool is not None:
            # a host placement supersedes any stale pooled copy
            self.pool.delete(key)

    def get_async(self, key, from_host: int = 0):
        """Issue a non-blocking fetch. Local replica -> the plain
        single-host path; otherwise the remote composition of the owner
        host's flash service and its egress NIC service."""
        if self.hosts[from_host].tier_of(key) is not None:
            self.local_fetches += 1
            return self.hosts[from_host].get_async(key)
        if self.pool is not None and self.pool.has(key):
            # pooled copy: one hop over this host's pool lane — checked
            # between the local-DRAM miss and the remote-flash
            # composition, which is exactly where the tier sits
            self.pool_fetches += 1
            return self.pool.get_async(
                key, from_host=from_host,
                on_wait=lambda pf: self._after_pool_fetch(pf, from_host))
        held = self.holders(key)
        if not held:
            raise KeyError(key)
        owner = held[0]
        pf = self.hosts[owner].get_async(key)
        nic_tr = self._nic_submit(owner, from_host, key, pf.value.nbytes,
                                  kind="fetch",
                                  not_before=pf.transfer.done_t)
        # prefetch hit/late classification must see the COMPOSED
        # completion (flash + NIC), not just the flash leg
        pf.external_done_t = nic_tr.done_t
        self.remote_fetches += 1
        return RemoteFetch(fabric=self, pf=pf, nic_tr=nic_tr, owner=owner,
                           dst=from_host)

    def get(self, key, from_host: int = 0) -> np.ndarray:
        return self.get_async(key, from_host=from_host).wait()

    # ----------------------------------------------------------- pool hooks
    def _pool_admit(self, key, tier: Tier, from_host: int) -> bool:
        """Ask the writing host's gate whether `key` belongs in the
        fleet pool. Plain policies have no `pool_admit` hook and never
        pool; the decision is economic (tracked reuse vs the pool
        column's tau_be), not structural."""
        if self.pool is None:
            return False
        hook = getattr(self.hosts[from_host].policy, "pool_admit", None)
        if hook is None:
            return False
        return bool(hook(key, tier, now=self.clock.now()))

    def _pool_evict(self, key, value, owner: int) -> None:
        """Pool capacity pressure spills the LRU victim back to flash
        on its pooling host (or the ring owner when that host has since
        failed) — the pool never drops committed bytes."""
        h = owner if owner in self.hosts else self.owner(key)
        self.hosts[h].ingest(key, value, tier=Tier.FLASH)

    def _after_pool_fetch(self, pf: PooledFetch, from_host: int) -> None:
        """Post-wait hook on a pool read: the access is a reuse event
        (one policy observation), and an object the policy now wants
        warm is promoted into the reading host's hierarchy — placed via
        `ingest` (no re-admission round-trip) with the pooled copy
        retired."""
        policy = self.hosts[from_host].policy
        want = policy.observe(pf.key, now=self.clock.now())
        if want < Tier.FLASH:
            self.hosts[from_host].ingest(pf.key, pf.value, tier=want)
            self.pool.delete(pf.key)
            self.pool.stats.promotions += 1

    def tier_of(self, key) -> Optional[Tier]:
        for h in self.ring_hosts(key):
            t = self.hosts[h].tier_of(key)
            if t is not None:
                return t
        if self.pool is not None and self.pool.has(key):
            return Tier.POOL
        return None

    def move(self, key, dst: Tier):
        for h in self.holders(key):
            self.hosts[h].move(key, dst)

    def delete(self, key):
        for h in self.holders(key):
            self.hosts[h].delete(key)
        if self.pool is not None:
            self.pool.delete(key)
        self._key_replicas.pop(key, None)
        # a deleted key must leave the reuse bookkeeping too: a later
        # re-put is a first touch, not a measured "reuse" across the gap
        self._notify_key_loss([key])

    def host_view(self, host: int, replicas: int = 1) -> HostView:
        return HostView(self, host, replicas=replicas)

    # ------------------------------------------------------ prefetch sizing
    def estimate_fetch_seconds(self, key, from_host: int = 0) -> float:
        """Tail-aware fetch estimate from `from_host`'s vantage point: a
        local replica is the single-host p99 estimate; a remote fetch
        adds the owner's egress NIC service (per-pair under topology) on
        top of the owner's flash estimate."""
        if self.hosts[from_host].tier_of(key) is not None:
            return self.hosts[from_host].estimate_fetch_seconds(key)
        if self.pool is not None and self.pool.has(key):
            lane = self.pool.lanes.get(from_host)
            if lane is None:
                raise KeyError(key)
            nbytes = self.pool.nbytes_of(key)
            depth = self.pool.runtime.queue_depth(lane) + 1
            svc = self.pool.lane_model.service(nbytes, depth)
            return svc.occupancy + svc.latency
        held = self.holders(key)
        if not held:
            raise KeyError(key)
        owner = held[0]
        est = self.hosts[owner].estimate_fetch_seconds(key)
        nbytes = self.hosts[owner].nbytes_of(key)
        depth = self.nic[owner].queue_depth(NIC) + 1
        if self.net_model.topology is not None:
            svc = self.net_model.service(nbytes, depth, src=owner,
                                         dst=from_host, fan_in=1)
        else:
            svc = self.net_model.service(nbytes, depth)
        return est + svc.occupancy + svc.latency

    def prefetch_lead_steps(self, key, step_time: float,
                            from_host: int = 0) -> int:
        """p99-sized prefetch lead for restoring `key` on `from_host`:
        issue the fetch `ceil(estimate / step_time)` decode steps early
        (>= 1) instead of a fixed lead."""
        return lead_steps_from_estimate(
            self.estimate_fetch_seconds(key, from_host=from_host),
            step_time)

    # ---------------------------------------------------------- elasticity
    def add_host(self, specs: Optional[Dict[Tier, TierSpec]] = None,
                 weight: float = 1.0) -> RebalanceStats:
        """Join a new host: recompute the ring and stream only the
        remapped ~weight/total of resident keys to it as background
        rebalance transfers (source flash read -> source egress NIC ->
        destination placement, the write subject to the destination's
        write shield). Serving continues; it queues behind the rebalance
        traffic. `specs`/`weight` admit a non-template host into a
        heterogeneous fleet (defaults: the shared tier specs, weight 1)."""
        h = self._new_host(specs=specs, weight=weight)
        self._rebuild_ring()
        self._policy_instant("autoscale_add_host",
                             {"host": h, "weight": float(weight)})
        return self._rebalance("join", h)

    def remove_host(self, host: int) -> RebalanceStats:
        """Drain a leaving host: recompute the ring without it, stream
        every key it uniquely holds to the new owners (preferring a
        surviving replica as source), then retire its store and NIC.
        In-flight egress finishes in the background (`drain` still
        covers retired queues)."""
        if host not in self.host_ids:
            raise KeyError(f"host {host} is not active")
        if self.n_hosts == 1:
            raise ValueError("cannot remove the last host")
        self.host_ids.remove(host)
        self._rebuild_ring()
        self._policy_instant("autoscale_remove_host", {"host": host})
        rb = self._rebalance("leave", host, extra_sources=(host,))
        self.retired[host] = (self.hosts.pop(host), self.nic.pop(host))
        if self.pool is not None:
            self.pool.detach_host(host)
        return rb

    def fail_host(self, host: int) -> FailureReport:
        """Unplanned failure: the host vanishes NOW — no drain, no
        retired queues. Keys resident only on it are lost (values gone,
        `_key_replicas` bookkeeping purged, `on_key_loss` and per-host
        policy `forget_keys` hooks fire); replicated keys survive on
        their other holders, and reads route around the dead host via
        `holders()` ring order (degraded reads).

        Fate-sharing boundary for in-flight transfers: an egress leg of
        the dead host that had not delivered dies with it (`RemoteFetch`
        handles re-issue from a surviving holder on wait), while a
        destination placement already recorded by `ingest` is modeled as
        durable — once the structural placement exists the bytes are
        committed to the wire. Restoring the declared replication degree
        of the surviving under-replicated keys is the repair loop's job
        (`repro_torch.runtime.repair.RepairLoop`)."""
        if host not in self.host_ids:
            raise KeyError(f"host {host} is not active")
        if self.n_hosts == 1:
            raise ValueError("cannot fail the last host")
        t_fail = self.clock.now()
        store = self.hosts.pop(host)
        self.nic.pop(host)
        self.host_ids.remove(host)
        self._rebuild_ring()
        self.failed[host] = t_fail
        if self.pool is not None:
            # the pool is fleet infrastructure and survives; only the
            # dead host's lane (and any bytes on it) dies
            self.pool.detach_host(host)
        # in-flight flows from the dead sender never arrive; stop
        # counting them toward any destination's incast fan-in
        self._nic_flows = [f for f in self._nic_flows if f[1] != host]
        dead_keys = store.keys()
        lost: List[object] = []
        bytes_lost = 0
        degraded = 0
        for key in dead_keys:
            if self.holders(key):
                degraded += 1
            else:
                lost.append(key)
                bytes_lost += store.nbytes_of(key)
                self._key_replicas.pop(key, None)
        report = FailureReport(
            host=host, t_fail=t_fail, keys_resident=len(dead_keys),
            keys_lost=len(lost), bytes_lost=bytes_lost,
            keys_degraded=degraded, lost_keys=tuple(lost))
        self.failures.append(report)
        self._policy_instant("fail_host", report.as_dict())
        if self.obs is not None and self.obs.metrics is not None:
            m = self.obs.metrics
            m.counter("host_failures").inc()
            m.counter("keys_lost").inc(v=float(len(lost)))
        self._notify_key_loss(lost)
        return report

    def under_replicated(self) -> List[object]:
        """Keys whose live copy set differs from their target placement:
        below the declared (clamped) replication degree after a failure,
        or left on non-target hosts by the ring change. Deterministic
        hash order — the repair loop's stream order."""
        resident = {k for s in self.hosts.values() for k in s.keys()}
        out: List[object] = []
        for key in sorted(resident,
                          key=lambda k: (self._key_point(k), repr(k))):
            if set(self.holders(key)) != set(self._targets(key)):
                out.append(key)
        return out

    def _notify_key_loss(self, keys: List[object]):
        """Fan lost/deleted keys out to every distinct per-host policy
        exposing `forget_keys` (ghost/EMA purge — see the satellite bug:
        stale last-seen entries turn a post-repair re-admission into a
        spurious measured reuse interval) and to the `on_key_loss`
        subscriber."""
        if not keys:
            return
        keys = list(keys)
        seen = set()
        for h in self.host_ids:
            policy = self.hosts[h].policy
            fk = getattr(policy, "forget_keys", None)
            if fk is not None and id(policy) not in seen:
                seen.add(id(policy))
                fk(keys)
        if self.on_key_loss is not None:
            self.on_key_loss(keys)

    def _rebalance(self, action: str, host: int,
                   extra_sources: Tuple[int, ...] = ()) -> RebalanceStats:
        rb = RebalanceStats(action=action, host=host,
                            t_start=self.clock.now())
        # rebalance pacing: per-source token bucket at `rebalance_rate`
        # bytes/s — each stream's flash read is released only when the
        # bucket has drained the previous streams' bytes, so the tax on
        # concurrent serving stays bounded even under short leads
        pace: Dict[int, float] = {}
        scan = list(self.host_ids) + [h for h in extra_sources
                                      if h not in self.host_ids]
        resident = {k for h in scan for k in self.hosts[h].keys()}
        # hash order makes the stream sequence independent of insertion
        # history (determinism across runs AND across equivalent states)
        for key in sorted(resident,
                          key=lambda k: (self._key_point(k), repr(k))):
            targets = self._targets(key)
            # ring-preference order, with leaving hosts last so a
            # surviving replica is preferred as the stream source
            held = [h for h in self.ring_hosts(key) + list(extra_sources)
                    if h in self.hosts
                    and self.hosts[h].tier_of(key) is not None]
            src = held[0]
            nbytes = self.hosts[src].nbytes_of(key)
            src_tier = self.hosts[src].tier_of(key)
            rb.keys_resident += 1
            rb.bytes_resident += nbytes
            moved = False
            for dst in targets:
                if dst in held:
                    continue
                release = None
                if self.rebalance_rate is not None:
                    release = max(self.clock.now(),
                                  pace.get(src, self.clock.now()))
                    pace[src] = release + nbytes / self.rebalance_rate
                value, tr = self.hosts[src].read_for_transfer(
                    key, not_before=release)
                nic_tr = self._nic_submit(src, dst, key, nbytes,
                                          kind="rebalance",
                                          not_before=tr.done_t)
                self.hosts[dst].ingest(key, value, tier=src_tier,
                                       not_before=nic_tr.done_t)
                rb.bytes_moved += nbytes
                rb.nic_transfers += 1
                moved = True
            if moved:
                rb.keys_moved += 1
            for h in held:
                if h not in targets:
                    self.hosts[h].delete(key)
        self.rebalances.append(rb)
        self._policy_instant("rebalance", rb.as_dict())
        return rb

    # ------------------------------------------------------------- control
    def drain(self) -> float:
        """Advance to the completion of every in-flight transfer on every
        host (tier queues and NICs, retired ones included), flushing
        shielded writes. Draining the tier queues completes the read
        bursts that shield deferred demotion writes, so flushing happens
        *after* each drain pass and the loop repeats until no transfer
        and no parked write remains."""
        t = self.clock.now()
        while True:
            stores, nics = self._all_stores(), self._all_nics()
            for store in stores:
                t = max(t, store.runtime.drain())
            for nic in nics:
                t = max(t, nic.drain())
            if self.pool is not None:
                t = max(t, self.pool.drain())
            if not any(store.flush_deferred_writes()
                       or store.deferred_writes_pending
                       for store in stores):
                return t

    def reset_stats(self):
        """Zero every per-host `TierStats`/`QueueStats`, every NIC lane's
        stats, and the fabric counters — not residency, parked writes,
        in-flight transfers, or recorded rebalances. Benchmarks call
        this between setup and the measured phase."""
        for store in self._all_stores():
            store.reset_stats()
        for nic in self._all_nics():
            nic.reset_stats()
        if self.pool is not None:
            self.pool.reset_stats()
        self.local_fetches = 0
        self.remote_fetches = 0
        self.remote_puts = 0
        self.pool_fetches = 0
        self.pool_puts = 0

    def snapshot_stats(self) -> Dict[str, object]:
        """Fleet-wide stats as plain dicts: per-host stores (retired
        included, keyed `retired{h}`), per-host NIC lanes, and the
        fabric counters (the `MetricsRegistry` snapshot/reset
        protocol)."""
        out: Dict[str, object] = {
            "hosts": {f"host{h}": self.hosts[h].snapshot_stats()
                      for h in self.host_ids},
            "nics": {f"host{h}": self.nic[h].snapshot_stats()
                     for h in self.host_ids},
            "retired": {f"retired{h}": s.snapshot_stats()
                        for h, (s, _) in sorted(self.retired.items())},
            "counters": {"local_fetches": self.local_fetches,
                         "remote_fetches": self.remote_fetches,
                         "remote_puts": self.remote_puts},
        }
        if self.pool is not None:
            out["pool"] = self.pool.snapshot_stats()
            out["counters"]["pool_fetches"] = self.pool_fetches
            out["counters"]["pool_puts"] = self.pool_puts
        return out

    def resident_bytes(self) -> int:
        """One copy per resident key (the fleet's unique payload)."""
        total = 0
        for key in {k for s in self.hosts.values() for k in s.keys()}:
            held = self.holders(key)
            if held:
                total += self.hosts[held[0]].nbytes_of(key)
        return total

    # --------------------------------------------------------------- stats
    def summary(self) -> Dict[str, float]:
        """Fabric-wide aggregates (plain floats — JSON/benchmark-ready)."""
        out = {
            "hosts": float(self.n_hosts),
            "local_fetches": float(self.local_fetches),
            "remote_fetches": float(self.remote_fetches),
            "remote_puts": float(self.remote_puts),
        }
        agg = {"prefetch_hits": 0, "prefetch_late": 0, "demotions": 0,
               "demotions_deferred": 0, "rebalance_deferred": 0,
               "deferred_bytes": 0}
        flash_stall = 0.0
        stores, nics = self._all_stores(), self._all_nics()
        for store in stores:
            for st in store.stats.values():
                for k in agg:
                    agg[k] += getattr(st, k)
            flash_stall += store.stats[Tier.FLASH].stall_time
        nic_stall = sum(n.qstats[NIC].stall_time for n in nics)
        nic_bytes = sum(n.qstats[NIC].bytes_moved for n in nics)
        out.update({k: float(v) for k, v in agg.items()})
        out["flash_stall"] = flash_stall
        out["nic_stall"] = nic_stall
        out["nic_bytes"] = float(nic_bytes)
        out["rebalances"] = float(len(self.rebalances))
        out["rebalance_keys_moved"] = float(
            sum(rb.keys_moved for rb in self.rebalances))
        out["rebalance_bytes_moved"] = float(
            sum(rb.bytes_moved for rb in self.rebalances))
        out["failed_hosts"] = float(len(self.failed))
        out["keys_lost"] = float(
            sum(r.keys_lost for r in self.failures))
        if self.pool is not None:
            ps = self.pool.stats
            out["pool_fetches"] = float(self.pool_fetches)
            out["pool_puts"] = float(self.pool_puts)
            out["pool_used_bytes"] = float(self.pool.used_bytes)
            out["pool_stall"] = float(ps.stall_time)
            out["pool_evictions"] = float(ps.evictions)
            out["pool_promotions"] = float(ps.promotions)
        return out

    def report(self) -> str:
        lines = []
        for h in self.host_ids:
            store, nst = self.hosts[h], self.nic[h].qstats[NIC]
            lines.append(f"host {h}:")
            lines.append(store.report())
            lines.append(
                f"NIC    xfers={nst.submitted:6d} "
                f"stall={nst.stall_time*1e3:9.3f}ms "
                f"bytes={nst.bytes_moved/2**20:9.1f}MiB "
                f"maxQ={nst.max_depth:3d}")
        s = self.summary()
        lines.append(
            f"fabric local={int(s['local_fetches'])} "
            f"remote={int(s['remote_fetches'])} "
            f"deferred_demotions={int(s['demotions_deferred'])} "
            f"rebalanced={s['rebalance_bytes_moved']/2**20:.1f}MiB "
            f"in {int(s['rebalances'])} events")
        return "\n".join(lines)
