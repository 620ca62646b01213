"""Event-driven SSD simulator (MQSim-Next core, paper §VI).

Channel/die/plane-level discrete-event model with:
  * shared per-channel command+data bus (SCA: short tau_cmd),
  * per-plane sense occupancy (independent multi-plane reads) with cache
    registers (the plane frees at sense end; transfer streams from the
    register, giving explicit transfer/sense overlap),
  * read-prioritized, plane-aware arbitration (ready host transfers first,
    then host read commands to free planes, then GC transfers, then host
    programs, then GC),
  * page-coalesced writes: the controller fills a per-plane buffer of
    blocks_per_page host blocks and commits them with one program,
  * page-granular GC: each host program spawns (phi_wa - 1) internal page
    reads, each followed by an internal program,
  * two-layer ECC: host reads escalate with probability p_bch to a full
    LDPC codeword transfer plus decode latency.

The model is intentionally parameterized identically to the closed-form
model in repro_torch.core.ssd_model so the two can be compared (paper Fig. 7).
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np

from .config import SimConfig


@dataclasses.dataclass
class SimResult:
    iops: float
    makespan: float
    n_ops: int
    n_reads: int
    n_writes: int
    mean_read_latency: float
    p99_read_latency: float
    bus_utilization: float          # mean across channels
    n_bch_escalations: int
    n_gc_reads: int
    n_gc_programs: int

    def __str__(self):
        return (f"SimResult(iops={self.iops/1e6:.2f}M, "
                f"mean_lat={self.mean_read_latency*1e6:.2f}us, "
                f"p99={self.p99_read_latency*1e6:.2f}us, "
                f"bus_util={self.bus_utilization:.2f})")


# event kinds (ordering tie-break by sequence number)
_ARR, _BUSFREE, _SENSE, _GCSENSE, _PROGDONE, _GCPROGDONE = range(6)


class _Channel:
    """Per-channel scheduler state."""

    __slots__ = ("bus_free", "ca_free", "busy_acc", "ready_xfer",
                 "gc_ready_xfer", "plane_free", "read_q", "pending_planes",
                 "wbuf", "full_progs", "gc_reads", "gc_progs", "gc_debt",
                 "rr_plane", "plane_keys")

    def __init__(self, n_dies: int, n_planes: int):
        self.bus_free = 0.0
        self.ca_free = 0.0
        self.busy_acc = 0.0
        self.ready_xfer: deque = deque()       # host reads sensed, await bus
        self.gc_ready_xfer: deque = deque()    # GC page reads sensed
        self.plane_keys: List[Tuple[int, int]] = [
            (d, p) for d in range(n_dies) for p in range(n_planes)]
        self.plane_free: Dict[Tuple[int, int], float] = {
            k: 0.0 for k in self.plane_keys}
        self.read_q: Dict[Tuple[int, int], deque] = {
            k: deque() for k in self.plane_keys}
        self.pending_planes: deque = deque()   # plane keys with queued reads
        self.wbuf: Dict[Tuple[int, int], int] = {
            k: 0 for k in self.plane_keys}
        self.full_progs: deque = deque()       # (plane_key, n_blocks)
        self.gc_reads = 0
        self.gc_progs = 0
        self.gc_debt = 0.0
        self.rr_plane = 0


class Simulator:
    def __init__(self, cfg: SimConfig):
        self.cfg = cfg
        ssd = cfg.ssd
        self.n_ch = ssd.n_ch
        self.n_dies = ssd.n_nand
        self.n_planes = ssd.nand.n_plane
        self.tau_cmd = ssd.tau_cmd
        # With SCA the short command/address bursts can optionally ride a
        # separate lane (sca_lane=True). The paper's analytic model charges
        # tau_CMD on the channel (Eq. IOPS_CH), and its Fig. 7c channel-bw
        # scaling matches that accounting, so the default keeps commands on
        # the shared bus and sca_lane is an explicit what-if knob.
        self.sca = bool(getattr(cfg, "sca_lane", False))
        self.tau_sense = ssd.nand.tau_sense
        self.tau_prog = ssd.nand.tau_prog
        self.b_ch = ssd.b_ch
        self.page = ssd.nand.page_bytes
        self.P = cfg.blocks_per_page
        self.l_eff = cfg.l_eff
        self.rng = np.random.default_rng(cfg.seed)
        self.channels = [_Channel(self.n_dies, self.n_planes)
                         for _ in range(self.n_ch)]
        self.events: list = []
        self._seq = itertools.count()
        # stats
        self.read_lat: List[float] = []
        self.completions = 0
        self.last_completion = 0.0
        self.t_end = 0.0               # end of ALL work incl. GC drain
        self.n_reads = self.n_writes = 0
        self.n_bch = 0
        self.n_gc_reads = self.n_gc_progs = 0
        self._wr_rr = 0  # round-robin pointer for write placement
        self._arrivals_left = 0
        # closed-loop mode: inject a replacement op on each completion
        self._closed_remaining = 0
        self.completion_times: List[float] = []

    # ------------------------------------------------------------------ util
    def _push(self, t: float, kind: int, ch: int, a=0, b=0.0):
        heapq.heappush(self.events, (t, next(self._seq), kind, ch, a, b))

    def _xfer_time(self, nbytes: float) -> float:
        return nbytes / self.b_ch

    # ------------------------------------------------------------- workload
    def load(self, arrival_times: np.ndarray, is_read: np.ndarray):
        """Queue a host op stream. Writes are placed round-robin."""
        assert len(arrival_times) == len(is_read)
        self._arrivals_left = len(arrival_times)
        read_ch = self.rng.integers(0, self.n_ch, size=len(is_read))
        read_die = self.rng.integers(0, self.n_dies, size=len(is_read))
        read_pl = self.rng.integers(0, self.n_planes, size=len(is_read))
        for i, (t, rd) in enumerate(zip(arrival_times, is_read)):
            self._push(float(t), _ARR, int(read_ch[i]), int(rd),
                       float(read_die[i] * self.n_planes + read_pl[i]))

    def load_closed_loop(self, n_ops: int, queue_depth: int = 4096):
        """Closed-system saturation: `queue_depth` ops outstanding; each
        completion injects a fresh op, keeping the read/write mix stationary
        (no phase separation between the read and write/GC streams)."""
        qd = min(queue_depth, n_ops)
        self._closed_remaining = n_ops - qd
        self._arrivals_left = n_ops
        for _ in range(qd):
            self._inject(0.0)

    def _inject(self, t: float):
        rd = int(self.rng.random() < self.cfg.read_frac)
        ch = int(self.rng.integers(0, self.n_ch))
        plane_idx = float(self.rng.integers(0, self.n_dies * self.n_planes))
        self._push(t, _ARR, ch, rd, plane_idx)

    def _maybe_refill(self, t: float, n: int = 1):
        for _ in range(n):
            if self._closed_remaining > 0:
                self._closed_remaining -= 1
                self._inject(t)

    # ------------------------------------------------------------- schedule
    def _schedule(self, ch_id: int, t: float):
        """Advance both channel lanes (read-prioritized).

        With SCA, read commands issue on the CA lane concurrently with data
        transfers; on conventional devices every action serializes on the
        shared bus (ca_free is aliased to bus_free)."""
        ch = self.channels[ch_id]
        self._schedule_ca(ch, ch_id, t)
        self._schedule_data(ch, ch_id, t)

    def _schedule_ca(self, ch: _Channel, ch_id: int, t: float):
        """Command/address issue: host read commands, then GC reads."""
        lane_free = ch.ca_free if self.sca else ch.bus_free
        if lane_free > t + 1e-15:
            return
        start = max(lane_free, t)
        key = self._pick_pending_read_plane(ch, start)
        if key is not None:
            arr_t = ch.read_q[key].popleft()
            if ch.read_q[key]:
                ch.pending_planes.append(key)
            end = start + self.tau_cmd
            self._finish_ca(ch, ch_id, start, end)
            sense_done = end + self.tau_sense
            ch.plane_free[key] = sense_done
            self._push(sense_done, _SENSE, ch_id, 0, arr_t)
            return
        if ch.gc_reads > 0:
            key = self._any_free_plane(ch, start)
            if key is not None:
                ch.gc_reads -= 1
                end = start + self.tau_cmd
                self._finish_ca(ch, ch_id, start, end)
                sense_done = end + self.tau_sense
                ch.plane_free[key] = sense_done
                self._push(sense_done, _GCSENSE, ch_id, 0, 0.0)

    def _schedule_data(self, ch: _Channel, ch_id: int, t: float):
        """Data-bus actions: read transfers first, then programs — unless
        the program backlog exceeds one page per plane, in which case
        writes preempt (bounded write buffer, as in real controllers;
        without this, strict read priority defers writes indefinitely
        under closed-loop saturation and overstates mixed-workload IOPS).
        """
        if ch.bus_free > t + 1e-15:
            return
        start = max(ch.bus_free, t)

        backlog = len(ch.full_progs) + ch.gc_progs
        if backlog > len(ch.plane_keys):
            cmd = 0.0 if self.sca else self.tau_cmd
            prog = self._pick_program(ch, start)
            if prog is not None:
                key, n_blocks = prog
                end = start + cmd + self._xfer_time(self.page)
                self._finish_bus(ch, ch_id, start, end)
                prog_done = end + self.tau_prog
                ch.plane_free[key] = prog_done
                self._push(prog_done, _PROGDONE, ch_id, n_blocks, 0.0)
                return
            if ch.gc_progs > 0:
                key = self._any_free_plane(ch, start)
                if key is not None:
                    ch.gc_progs -= 1
                    end = start + cmd + self._xfer_time(self.page)
                    self._finish_bus(ch, ch_id, start, end)
                    prog_done = end + self.tau_prog
                    ch.plane_free[key] = prog_done
                    self._push(prog_done, _GCPROGDONE, ch_id, 0, 0.0)
                    return

        # 1. host read data transfer (sense already done)
        if ch.ready_xfer:
            arr_t, = (ch.ready_xfer.popleft(),)
            nbytes = self.l_eff
            extra = 0.0
            if self.cfg.p_bch > 0 and self.rng.random() < self.cfg.p_bch:
                nbytes = max(nbytes, self.cfg.ldpc_codeword)
                extra = self.cfg.ldpc_decode_time
                self.n_bch += 1
            end = start + self._xfer_time(nbytes)
            self._finish_bus(ch, ch_id, start, end)
            done = end + extra
            self.read_lat.append(done - arr_t)
            self._complete(done)
            return

        # 2. GC page-read transfer
        if ch.gc_ready_xfer:
            ch.gc_ready_xfer.popleft()
            end = start + self._xfer_time(self.page)
            self._finish_bus(ch, ch_id, start, end)
            ch.gc_progs += 1
            self.n_gc_progs += 1
            return

        # 3. host program for a coalesced page on a free plane
        cmd = 0.0 if self.sca else self.tau_cmd
        prog = self._pick_program(ch, start)
        if prog is not None:
            key, n_blocks = prog
            end = start + cmd + self._xfer_time(self.page)
            self._finish_bus(ch, ch_id, start, end)
            prog_done = end + self.tau_prog
            ch.plane_free[key] = prog_done
            self._push(prog_done, _PROGDONE, ch_id, n_blocks, 0.0)
            return

        # 4. GC program to a free plane
        if ch.gc_progs > 0:
            key = self._any_free_plane(ch, start)
            if key is not None:
                ch.gc_progs -= 1
                end = start + cmd + self._xfer_time(self.page)
                self._finish_bus(ch, ch_id, start, end)
                prog_done = end + self.tau_prog
                ch.plane_free[key] = prog_done
                self._push(prog_done, _GCPROGDONE, ch_id, 0, 0.0)
                return

    def _finish_ca(self, ch: _Channel, ch_id: int, start: float,
                   end: float):
        if self.sca:
            ch.ca_free = end
        else:
            ch.bus_free = end
            ch.busy_acc += end - start
        self.t_end = max(self.t_end, end)
        self._push(end, _BUSFREE, ch_id)

    def _finish_bus(self, ch: _Channel, ch_id: int, start: float, end: float):
        ch.bus_free = end
        ch.busy_acc += end - start
        self.t_end = max(self.t_end, end)
        self._push(end, _BUSFREE, ch_id)

    def _pick_pending_read_plane(self, ch: _Channel, t: float):
        """First queued-read plane that is free; rotates for fairness."""
        for _ in range(len(ch.pending_planes)):
            key = ch.pending_planes.popleft()
            if not ch.read_q[key]:
                continue                      # stale entry, drop
            if ch.plane_free[key] <= t + 1e-15:
                return key
            ch.pending_planes.append(key)
        return None

    def _pick_program(self, ch: _Channel, t: float):
        for _ in range(len(ch.full_progs)):
            key, n = ch.full_progs.popleft()
            if ch.plane_free[key] <= t + 1e-15:
                return key, n
            ch.full_progs.append((key, n))
        return None

    def _any_free_plane(self, ch: _Channel, t: float):
        n = len(ch.plane_keys)
        for i in range(n):
            key = ch.plane_keys[(ch.rr_plane + i) % n]
            if ch.plane_free[key] <= t + 1e-15:
                ch.rr_plane = (ch.rr_plane + i + 1) % n
                return key
        return None

    def _complete(self, t: float):
        self.completions += 1
        self.completion_times.append(t)
        self.last_completion = max(self.last_completion, t)
        self._maybe_refill(t)

    # ----------------------------------------------------------------- run
    def run(self) -> SimResult:
        cfg = self.cfg
        events = self.events
        while events:
            t, _, kind, ch_id, a, b = heapq.heappop(events)
            self.t_end = max(self.t_end, t)
            ch = self.channels[ch_id]
            if kind == _ARR:
                self._arrivals_left -= 1
                if a:  # read
                    self.n_reads += 1
                    key = ch.plane_keys[int(b)]
                    ch.read_q[key].append(t)
                    if len(ch.read_q[key]) == 1:
                        ch.pending_planes.append(key)
                else:   # write: round-robin plane placement, page coalescing
                    self.n_writes += 1
                    wch = self.channels[self._wr_rr % self.n_ch]
                    wch_id = self._wr_rr % self.n_ch
                    self._wr_rr += 1
                    key = wch.plane_keys[
                        (self._wr_rr // self.n_ch) % len(wch.plane_keys)]
                    wch.wbuf[key] += 1
                    if wch.wbuf[key] >= self.P:
                        wch.full_progs.append((key, wch.wbuf[key]))
                        wch.wbuf[key] = 0
                    if wch_id != ch_id:
                        self._schedule(wch_id, t)
                if self._arrivals_left == 0:
                    self._flush_partial_pages()
                self._schedule(ch_id, t)
            elif kind == _BUSFREE:
                self._schedule(ch_id, t)
            elif kind == _SENSE:
                ch.ready_xfer.append(b)      # b = arrival time
                self._schedule(ch_id, t)
            elif kind == _GCSENSE:
                ch.gc_ready_xfer.append(t)
                self._schedule(ch_id, t)
            elif kind == _PROGDONE:
                # a = host blocks committed by this program
                for _ in range(int(a)):
                    self._complete(t)
                # spawn GC debt: (phi_wa - 1) page moves per host page
                ch.gc_debt += (cfg.phi_wa - 1.0) * (int(a) / self.P)
                while ch.gc_debt >= 1.0:
                    ch.gc_debt -= 1.0
                    ch.gc_reads += 1
                    self.n_gc_reads += 1
                self._schedule(ch_id, t)
            elif kind == _GCPROGDONE:
                self._schedule(ch_id, t)

        # Throughput is measured over the steady-state window (10th..90th
        # completion percentile): the saturation preload starts with cold
        # write buffers / no GC backlog and ends with a GC drain tail, and
        # both transients dilute the whole-makespan rate.
        makespan = max(self.t_end, self.last_completion, 1e-12)
        lat = np.asarray(self.read_lat) if self.read_lat else np.zeros(1)
        util = float(np.mean([c.busy_acc for c in self.channels])) / makespan
        n_ops = self.n_reads + self.n_writes
        ct = np.sort(np.asarray(self.completion_times))
        if len(ct) >= 100:
            lo, hi = int(0.1 * len(ct)), int(0.9 * len(ct))
            window = max(ct[hi - 1] - ct[lo], 1e-12)
            steady_iops = (hi - lo) / window
        else:
            steady_iops = self.completions / makespan
        return SimResult(
            iops=steady_iops, makespan=makespan,
            n_ops=n_ops, n_reads=self.n_reads, n_writes=self.n_writes,
            mean_read_latency=float(lat.mean()),
            p99_read_latency=float(np.percentile(lat, 99)),
            bus_utilization=util, n_bch_escalations=self.n_bch,
            n_gc_reads=self.n_gc_reads, n_gc_programs=self.n_gc_progs)

    def _flush_partial_pages(self):
        for ch in self.channels:
            for key, n in ch.wbuf.items():
                if n > 0:
                    ch.full_progs.append((key, n))
                    ch.wbuf[key] = 0


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def simulate(cfg: SimConfig, arrival_times: np.ndarray,
             is_read: np.ndarray) -> SimResult:
    sim = Simulator(cfg)
    sim.load(arrival_times, is_read)
    return sim.run()


def simulate_peak_iops(cfg: SimConfig, n_ops: int = 60_000,
                       queue_depth: int = 4096) -> SimResult:
    """Saturation throughput via a closed system: `queue_depth` ops stay
    outstanding and every completion injects a replacement, keeping the
    read/write mix stationary (an all-at-t=0 preload phase-separates reads
    from writes under the read-prioritized scheduler and misstates the
    mix sensitivity)."""
    sim = Simulator(cfg)
    sim.load_closed_loop(n_ops, queue_depth)
    return sim.run()


def simulate_latency(cfg: SimConfig, rho: float, n_ops: int = 40_000,
                     peak_iops: Optional[float] = None) -> SimResult:
    """Open-loop Poisson arrivals at rho x peak (M/D/1 validation, §IV)."""
    if peak_iops is None:
        peak_iops = simulate_peak_iops(cfg, n_ops=min(n_ops, 40_000)).iops
    rate = rho * peak_iops
    rng = np.random.default_rng(cfg.seed + 2)
    gaps = rng.exponential(1.0 / rate, size=n_ops)
    arrivals = np.cumsum(gaps)
    is_read = rng.random(n_ops) < cfg.read_frac
    return simulate(cfg, arrivals, is_read)
