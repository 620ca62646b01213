"""Deterministic causal tracer with Perfetto/Chrome export.

Records the modeled request lifecycle as `trace_event` JSON that the
Perfetto UI (https://ui.perfetto.dev) opens directly: "X" complete
events for spans whose duration is known at record time (every modeled
transfer knows its `done_t` the moment it is submitted — so spans are
recorded *at submit*, with explicit ts/dur, rather than via begin/end
pairs), "i" instants for policy decisions (gate admit/price-out,
autoscaler add/remove, host failure, deadline misses), and "s"/"f"
flow events stitching a session's admission to the fetches and resume
that served it.

Determinism contract: timestamps come off the `VirtualClock` (modeled
seconds -> microseconds), pids/tids are assigned in first-registration
order from deterministic component labels, flow ids from a monotone
counter keyed by session id, and the export canonicalizes floats the
same way `obs.jsonio` does — so a double run under the same spec JSON
and seed produces a byte-identical trace file, which CI diffs.

The tracer is bounded: past `max_events` new events are dropped (and
counted), never resized — a trace of a 1M-key replay should truncate,
not OOM.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

from .jsonio import canon

_US = 1e6    # modeled seconds -> trace microseconds


class Tracer:
    def __init__(self, max_events: int = 200_000):
        self.max_events = int(max_events)
        self.dropped = 0
        self._events: List[dict] = []
        self._pids: Dict[str, int] = {}
        self._tids: Dict[Tuple[int, str], int] = {}
        self._flow_ids: Dict[object, int] = {}

    # -------------------------------------------------------------- tracks
    def track(self, process: str, thread: str = "main") -> Tuple[int, int]:
        """(pid, tid) for a component track, assigned deterministically
        in first-registration order; emits the Perfetto name metadata
        on first sight so the UI shows labels, not numbers."""
        pid = self._pids.get(process)
        if pid is None:
            pid = self._pids[process] = len(self._pids) + 1
            self._meta(pid, 0, "process_name", {"name": process})
        tid = self._tids.get((pid, thread))
        if tid is None:
            tid = self._tids[(pid, thread)] = (
                len([1 for (p, _) in self._tids if p == pid]) + 1)
            self._meta(pid, tid, "thread_name", {"name": thread})
        return pid, tid

    def _meta(self, pid: int, tid: int, name: str, args: dict) -> None:
        # metadata events bypass the max_events bound (they are O(tracks))
        self._events.append({"ph": "M", "pid": pid, "tid": tid,
                             "name": name, "args": args})

    def _emit(self, ev: dict) -> bool:
        if len(self._events) >= self.max_events:
            self.dropped += 1
            return False
        self._events.append(ev)
        return True

    # -------------------------------------------------------------- events
    def complete(self, track: Tuple[int, int], name: str, ts: float,
                 dur: float, cat: str = "", args: Optional[dict] = None
                 ) -> None:
        """A span with explicit start + duration (modeled seconds)."""
        pid, tid = track
        ev = {"ph": "X", "pid": pid, "tid": tid, "name": name,
              "ts": ts * _US, "dur": max(dur, 0.0) * _US}
        if cat:
            ev["cat"] = cat
        if args:
            ev["args"] = args
        self._emit(ev)

    def instant(self, track: Tuple[int, int], name: str, ts: float,
                args: Optional[dict] = None, cat: str = "") -> None:
        pid, tid = track
        ev = {"ph": "i", "pid": pid, "tid": tid, "name": name,
              "ts": ts * _US, "s": "t"}
        if cat:
            ev["cat"] = cat
        if args:
            ev["args"] = args
        self._emit(ev)

    # --------------------------------------------------------------- flows
    def flow_id(self, key) -> int:
        """Deterministic flow id for a causal chain (e.g. a session)."""
        fid = self._flow_ids.get(key)
        if fid is None:
            fid = self._flow_ids[key] = len(self._flow_ids) + 1
        return fid

    def _flow(self, ph: str, track: Tuple[int, int], name: str,
              ts: float, key) -> None:
        pid, tid = track
        ev = {"ph": ph, "pid": pid, "tid": tid, "name": name,
              "ts": ts * _US, "id": self.flow_id(key), "cat": "flow"}
        if ph == "f":
            ev["bp"] = "e"
        self._emit(ev)

    def flow_start(self, track, name, ts, key) -> None:
        self._flow("s", track, name, ts, key)

    def flow_step(self, track, name, ts, key) -> None:
        self._flow("t", track, name, ts, key)

    def flow_end(self, track, name, ts, key) -> None:
        self._flow("f", track, name, ts, key)

    # ------------------------------------------------------------- exports
    def to_chrome_json(self) -> str:
        """Byte-stable Chrome `trace_event` JSON (load in Perfetto or
        chrome://tracing). Events stay in record order — stable because
        recording order is itself deterministic."""
        doc = {"traceEvents": canon(self._events),
               "displayTimeUnit": "ms",
               "otherData": {"dropped_events": self.dropped}}
        return json.dumps(doc, sort_keys=True, indent=1)

    def flamegraph(self) -> str:
        """Folded-stacks text of modeled time: one line per
        `process;thread;name` with total microseconds of span time —
        feed to any flamegraph renderer, or read directly as a sorted
        where-did-modeled-time-go table."""
        names_pid = {v: k for k, v in self._pids.items()}
        names_tid = {(p, t): n for (p, n), t in self._tids.items()}
        agg: Dict[str, float] = {}
        for ev in self._events:
            if ev.get("ph") != "X":
                continue
            proc = names_pid.get(ev["pid"], str(ev["pid"]))
            thr = names_tid.get((ev["pid"], ev["tid"]), str(ev["tid"]))
            stack = f"{proc};{thr};{ev['name']}"
            agg[stack] = agg.get(stack, 0.0) + ev["dur"]
        lines = [f"{stack} {int(round(us))}"
                 for stack, us in sorted(agg.items())]
        return "\n".join(lines)

    def __len__(self) -> int:
        return len(self._events)
