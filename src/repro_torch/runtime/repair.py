"""RepairLoop — background re-replication after unplanned host failure.

`ShardedTieredStore.fail_host` removes a host with no drain: replicated
keys survive on their other holders but drop below their declared
replication degree, and the ring change can leave surviving copies on
hosts that are no longer placement targets. The repair loop walks the
fabric's `under_replicated()` set in deterministic hash order and
streams each missing copy exactly like a planned rebalance — a
`read_for_transfer` on the best surviving holder (ring-preference
order), the sender's egress NIC gated on the read, and a destination
`ingest` whose write is subject to the destination's write shield and
readability gating — all under the fabric's `rebalance_rate` token
bucket, so repair traffic is paced like rebalance traffic and serving
continues throughout (it only queues behind the repair streams).

`step()` repairs one bounded batch (background operation, interleaved
with serving); `run()` loops until no key is under-replicated or
misplaced. `RepairStats.t_done` is the wire horizon of the last repair
stream, so recovery time for a failure is
`t_done - FailureReport.t_fail` — what the failover benchmark reports
per replication factor.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from .fabric import ShardedTieredStore


@dataclasses.dataclass
class RepairStats:
    """One repair pass: what re-replication actually moved."""
    t_start: float
    t_done: float = 0.0         # wire horizon of the last repair stream
    keys_scanned: int = 0       # under-replicated/misplaced keys visited
    keys_repaired: int = 0
    bytes_repaired: int = 0
    nic_transfers: int = 0
    copies_dropped: int = 0     # surplus copies on non-target hosts

    @property
    def duration(self) -> float:
        """Seconds from pass start to the last stream's delivery."""
        return max(0.0, self.t_done - self.t_start)

    def as_dict(self) -> Dict[str, float]:
        return {
            "t_start": float(self.t_start),
            "t_done": float(self.t_done),
            "duration": float(self.duration),
            "keys_scanned": float(self.keys_scanned),
            "keys_repaired": float(self.keys_repaired),
            "bytes_repaired": float(self.bytes_repaired),
            "nic_transfers": float(self.nic_transfers),
            "copies_dropped": float(self.copies_dropped),
        }


class RepairLoop:
    """Paced re-replication of a fabric's under-replicated keys."""

    def __init__(self, fabric: ShardedTieredStore, batch_keys: int = 64):
        if batch_keys < 1:
            raise ValueError("batch_keys must be >= 1")
        self.fabric = fabric
        self.batch_keys = batch_keys
        # per-source token bucket (same shape as the rebalance pacer);
        # persists across step() calls so interleaved batches share one
        # budget instead of resetting the bucket every batch
        self._pace: Dict[int, float] = {}

    def pending(self) -> List[object]:
        """Keys still needing repair, in deterministic stream order."""
        return self.fabric.under_replicated()

    def _repair_key(self, key, stats: RepairStats):
        fab = self.fabric
        targets = fab._targets(key)
        held = fab.holders(key)
        stats.keys_scanned += 1
        if set(held) == set(targets):
            return
        src = held[0]               # best surviving holder, ring order
        nbytes = fab.hosts[src].nbytes_of(key)
        src_tier = fab.hosts[src].tier_of(key)
        for dst in targets:
            if dst in held:
                continue
            release = None
            if fab.rebalance_rate is not None:
                now = fab.clock.now()
                release = max(now, self._pace.get(src, now))
                self._pace[src] = release + nbytes / fab.rebalance_rate
            value, tr = fab.hosts[src].read_for_transfer(
                key, not_before=release)
            nic_tr = fab._nic_submit(src, dst, key, nbytes,
                                     kind="repair", not_before=tr.done_t)
            fab.hosts[dst].ingest(key, value, tier=src_tier,
                                  not_before=nic_tr.done_t)
            stats.bytes_repaired += nbytes
            stats.nic_transfers += 1
            stats.t_done = max(stats.t_done, nic_tr.done_t)
        for h in held:
            if h not in targets:
                fab.hosts[h].delete(key)
                stats.copies_dropped += 1
        stats.keys_repaired += 1

    def run(self, max_keys: Optional[int] = None) -> RepairStats:
        """Repair until nothing is under-replicated or misplaced (or up
        to `max_keys` keys). Re-scans between batches: an `ingest` is a
        structural placement, so repaired keys leave the pending set
        immediately and the loop converges."""
        now = self.fabric.clock.now()
        stats = RepairStats(t_start=now, t_done=now)
        while True:
            pending = self.pending()
            if not pending:
                break
            if max_keys is not None:
                pending = pending[:max(0, max_keys - stats.keys_scanned)]
                if not pending:
                    break
            for key in pending[:self.batch_keys]:
                self._repair_key(key, stats)
        if stats.keys_repaired:
            self.fabric._policy_instant("repair_pass", stats.as_dict())
        return stats

    def step(self) -> RepairStats:
        """One bounded batch of repairs (`batch_keys`), for interleaving
        with serving traffic."""
        return self.run(max_keys=self.batch_keys)
