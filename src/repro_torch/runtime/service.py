"""Per-tier service-time models for the async tiering runtime.

The flash tier's service times come from the calibrated `ssdsim`
discrete-event engine: `SsdQueueModel` runs the simulator once per config
at a ladder of queue depths (closed-loop saturation, 4KiB-granular reads)
and interpolates (mean latency, achieved IOPS) between them. A fetch of
`nbytes` at in-flight depth `d` then costs

    occupancy = ceil(nbytes / 4KiB) / IOPS(d)      # throughput share
    latency   = occupancy + mean_read_latency(d)   # access time overlaps

The runtime serializes occupancies (deeper queue -> longer waits) while
latencies pipeline. DRAM/HBM keep the fixed-latency model.
`NetQueueModel` extends the same occupancy/latency split to the
cross-host NIC tier of the sharded fabric (`runtime.fabric`): fixed RTT
latency, wire occupancy at the bandwidth share the link sustains at the
current in-flight depth.

Calibration is deterministic (fixed sim seed) and cached per SimConfig,
so tests pay it once per process. Set the `REPRO_SSDSIM_CACHE` env var
to a directory to also persist calibration across processes; cache files
are keyed by a digest of the SimConfig, op count, depth ladder and a
format version, and carry this package's own `ssdcal-torch-` prefix so
that the JAX reference package and the port never read each other's
files from a shared directory.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
import pathlib
import tempfile
from typing import Dict, Optional, Tuple

import numpy as np

from ..ssdsim.config import SimConfig
from ..ssdsim.engine import simulate_latency, simulate_peak_iops

CACHE_ENV = "REPRO_SSDSIM_CACHE"
CACHE_PREFIX = "ssdcal-torch-"
_CAL_VERSION = 2            # bump when the cached-file schema changes


@dataclasses.dataclass(frozen=True)
class Service:
    """One scheduled access: how long the tier stays occupied, and the
    additional pipelined latency before the data is usable."""
    occupancy: float
    latency: float

    @property
    def total(self) -> float:
        return self.occupancy + self.latency


class FixedLatencyModel:
    """Seed-style model for HBM/DRAM: latency + size/bandwidth."""

    def __init__(self, read_latency: float, read_bw: float):
        self.read_latency = read_latency
        self.read_bw = read_bw

    def service(self, nbytes: int, queue_depth: int) -> Service:
        return Service(occupancy=nbytes / self.read_bw,
                       latency=self.read_latency)


@dataclasses.dataclass(frozen=True)
class FabricTopology:
    """Rack/spine topology descriptor for the fabric's transfer tier.

    Hosts are packed `hosts_per_rack` to a rack; a pair in the same rack
    talks through the ToR switch (short RTT, full NIC bandwidth), a pair
    in different racks crosses the spine (longer RTT, and an
    oversubscribed share of the uplink). `incast_degree` is the fan-in a
    destination host absorbs at line rate; beyond it the senders split
    the receiver's ingress (the classic incast collapse, modeled as a
    linear bandwidth division so degradation is monotone in fan-in).
    """
    hosts_per_rack: int = 4
    rack_rtt: float = 15e-6
    spine_rtt: float = 40e-6
    rack_bandwidth: float = 12.5e9      # 100 Gb/s within the rack
    spine_bandwidth: float = 6.25e9     # 2:1 oversubscribed uplink share
    incast_degree: int = 2

    def __post_init__(self):
        if (self.hosts_per_rack < 1 or self.incast_degree < 1
                or self.rack_rtt < 0 or self.spine_rtt < self.rack_rtt
                or self.rack_bandwidth <= 0
                or self.spine_bandwidth <= 0):
            raise ValueError("invalid topology parameters")

    def rack_of(self, host: int) -> int:
        return int(host) // self.hosts_per_rack

    def same_rack(self, src: int, dst: int) -> bool:
        return self.rack_of(src) == self.rack_of(dst)

    def rtt(self, src: int, dst: int) -> float:
        return self.rack_rtt if self.same_rack(src, dst) else self.spine_rtt

    def bandwidth(self, src: int, dst: int) -> float:
        return (self.rack_bandwidth if self.same_rack(src, dst)
                else self.spine_bandwidth)

    def incast_factor(self, fan_in: int) -> float:
        """Ingress bandwidth divisor at `fan_in` concurrent senders:
        1.0 up to `incast_degree`, then linear — monotone in fan-in."""
        return max(1.0, float(fan_in) / self.incast_degree)


class NetQueueModel:
    """Cross-host NIC link service for the sharded fabric's transfer tier.

    Same occupancy/latency split as `SsdQueueModel`, with the NIC's
    queueing shape instead of flash's:

      occupancy = nbytes / eff_bw(depth)   # wire time at the bandwidth
                                           # share `depth` streams sustain
      latency   = rtt                      # fixed propagation + protocol

    A single stream is window-limited and cannot saturate the link;
    aggregate effective bandwidth ramps linearly until `sat_depth`
    concurrent transfers fill the pipe (the NIC analog of flash IOPS
    rising with queue depth). Occupancies serialize on the link in the
    runtime's queueing; RTT latencies pipeline. Defaults model a
    100 Gb/s fleet NIC at ~25us intra-cluster RTT.

    Topology mode: construct with `topology=FabricTopology(...)` and
    `service` becomes per-pair — the fabric passes `src`/`dst` host ids
    and the destination's current sender fan-in, so an intra-rack hop
    gets the short RTT at full bandwidth, a spine hop the longer RTT at
    the oversubscribed share, and high fan-in into one destination
    divides its ingress bandwidth (incast). Without a topology the
    uniform single-link behavior is unchanged (extra context ignored).
    """

    def __init__(self, rtt: float = 25e-6, bandwidth: float = 12.5e9,
                 sat_depth: int = 4,
                 topology: Optional[FabricTopology] = None):
        if rtt < 0 or bandwidth <= 0 or sat_depth < 1:
            raise ValueError("invalid NIC parameters")
        self.rtt = rtt
        self.bandwidth = bandwidth
        self.sat_depth = sat_depth
        self.topology = topology

    def service(self, nbytes: int, queue_depth: int,
                src: Optional[int] = None, dst: Optional[int] = None,
                fan_in: int = 1) -> Service:
        rtt, bw = self.rtt, self.bandwidth
        topo = self.topology
        if topo is not None and src is not None and dst is not None:
            rtt, bw = topo.rtt(src, dst), topo.bandwidth(src, dst)
            bw /= topo.incast_factor(max(1, int(fan_in)))
        d = max(1, min(int(queue_depth), self.sat_depth))
        eff_bw = bw * (d / self.sat_depth)
        return Service(occupancy=nbytes / eff_bw, latency=rtt)


class PoolLaneModel:
    """Per-host lane to the fleet-shared far-memory pool.

    Same occupancy/latency split as `NetQueueModel` — fixed RTT, a
    bandwidth share that ramps with in-flight depth — plus the write
    asymmetry the pool's ingest path needs: pooled DRAM is behind a
    fabric port whose egress (host reads) and ingress (host writes /
    demotions into the pool) can be provisioned differently. Each
    attached host owns one lane; occupancies serialize per lane in the
    runtime while the RTT pipelines, so one host's demotion burst
    queues on *its* lane without touching its neighbors'.
    """

    def __init__(self, rtt: float = 2e-6, read_bw: float = 40e9,
                 write_bw: Optional[float] = None, sat_depth: int = 4):
        if rtt < 0 or read_bw <= 0 or sat_depth < 1:
            raise ValueError("invalid pool-lane parameters")
        if write_bw is not None and write_bw <= 0:
            raise ValueError("invalid pool-lane write bandwidth")
        self.rtt = rtt
        self.read_bw = read_bw
        self.write_bw = read_bw if write_bw is None else write_bw
        self.sat_depth = sat_depth

    def service(self, nbytes: int, queue_depth: int,
                write: bool = False) -> Service:
        bw = self.write_bw if write else self.read_bw
        d = max(1, min(int(queue_depth), self.sat_depth))
        eff_bw = bw * (d / self.sat_depth)
        return Service(occupancy=nbytes / eff_bw, latency=self.rtt)


class SsdQueueModel:
    """Queue-depth-dependent flash service times from the ssdsim DES."""

    DEPTHS: Tuple[int, ...] = (1, 2, 4, 8, 16, 32, 64, 128)
    PAGE = 4096

    _cache: Dict[object, "SsdQueueModel"] = {}

    def __init__(self, sim_cfg: Optional[SimConfig] = None,
                 n_ops: int = 2500):
        # 4KiB-granular batched reads are the KV/expert fetch unit
        self.cfg = sim_cfg or SimConfig(l_blk=self.PAGE, read_frac=0.9)
        self.n_ops = n_ops
        self._iops: Optional[np.ndarray] = None
        self._lat: Optional[np.ndarray] = None
        self._p99: Optional[np.ndarray] = None

    @classmethod
    def shared(cls, sim_cfg: Optional[SimConfig] = None) -> "SsdQueueModel":
        key = sim_cfg  # SimConfig is a frozen dataclass -> hashable
        if key not in cls._cache:
            cls._cache[key] = cls(sim_cfg)
        return cls._cache[key]

    # ------------------------------------------------------------ disk cache
    def _cache_path(self) -> Optional[pathlib.Path]:
        root = os.environ.get(CACHE_ENV)
        if not root:
            return None
        spec = repr((self.cfg, self.n_ops, self.DEPTHS, _CAL_VERSION))
        digest = hashlib.blake2b(spec.encode(), digest_size=12).hexdigest()
        return pathlib.Path(root) / f"{CACHE_PREFIX}{digest}.json"

    def _load_cached(self) -> bool:
        path = self._cache_path()
        if path is None or not path.is_file():
            return False
        try:
            blob = json.loads(path.read_text())
            iops = np.asarray(blob["iops"], float)
            lat = np.asarray(blob["lat"], float)
            if len(iops) != len(self.DEPTHS) or len(lat) != len(self.DEPTHS):
                return False
            p99 = blob.get("p99")
            if p99 is not None:
                p99 = np.asarray(p99, float)
                if len(p99) != len(self.DEPTHS):
                    p99 = None
        except (ValueError, KeyError, TypeError, OSError):
            # a corrupt or foreign file is a cache miss, never a crash
            return False
        self._iops = iops
        self._lat = lat
        self._p99 = p99
        return True

    def _save_cached(self):
        path = self._cache_path()
        if path is None:
            return
        blob = {"iops": [float(x) for x in self._iops],
                "lat": [float(x) for x in self._lat]}
        if self._p99 is not None:
            blob["p99"] = [float(x) for x in self._p99]
        try:
            path.parent.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".tmp")
            with os.fdopen(fd, "w") as f:
                json.dump(blob, f, sort_keys=True)
            os.replace(tmp, path)
        except OSError:
            pass                            # cache is best-effort only

    # ------------------------------------------------------------ calibrate
    def _calibrate(self):
        if self._load_cached():
            self._xs = np.log2(np.asarray(self.DEPTHS, float))
            return
        iops, lat = [], []
        for qd in self.DEPTHS:
            r = simulate_peak_iops(self.cfg, n_ops=self.n_ops,
                                   queue_depth=qd)
            # reads carry the fetch path; guard against degenerate mixes
            iops.append(max(r.iops * self.cfg.read_frac, 1.0))
            lat.append(max(r.mean_read_latency, 1e-9))
        # Queueing theory guarantees throughput and mean latency are
        # non-decreasing in offered depth; the finite-op DES can exhibit
        # sub-sample-noise dips, so enforce isotonicity on the ladder
        # (interpolated values then inherit the monotone property).
        self._iops = np.maximum.accumulate(np.asarray(iops))
        self._lat = np.maximum.accumulate(np.asarray(lat))
        self._xs = np.log2(np.asarray(self.DEPTHS, float))
        self._save_cached()

    def _calibrate_p99(self):
        """Open-loop tail percentiles per calibrated depth (the p99-aware
        prefetch-lead prerequisite): drive the DES with Poisson arrivals
        at the utilization each depth achieves (rho_d = IOPS(d)/IOPS(max))
        and take the observed p99 read latency — the M/D/1-like tail at
        that load, which the closed-loop mean cannot show."""
        if self._iops is None:
            self._calibrate()
        if self._p99 is not None:
            return
        peak_total = float(self._iops[-1]) / max(self.cfg.read_frac, 1e-9)
        p99 = []
        for iops_d in self._iops:
            rho = float(np.clip(iops_d / self._iops[-1], 0.02, 0.95))
            r = simulate_latency(self.cfg, rho, n_ops=self.n_ops,
                                 peak_iops=peak_total)
            p99.append(max(r.p99_read_latency, 1e-9))
        self._p99 = np.maximum.accumulate(np.asarray(p99))
        self._save_cached()

    def calibration(self) -> Dict[int, Tuple[float, float, float]]:
        """(IOPS, mean latency, open-loop p99 latency) per calibrated
        depth — for reports and prefetch-lead sizing."""
        if self._iops is None:
            self._calibrate()
        if self._p99 is None:
            self._calibrate_p99()
        return {d: (float(i), float(l), float(p)) for d, i, l, p in
                zip(self.DEPTHS, self._iops, self._lat, self._p99)}

    def p99(self, queue_depth: int) -> float:
        """Interpolated open-loop p99 read latency at `queue_depth` — the
        tail the p99-sized prefetch lead must cover (`service().latency`
        is the closed-loop mean, which under-sizes the lead exactly when
        queueing matters)."""
        if self._p99 is None:
            self._calibrate_p99()
        d = float(np.clip(queue_depth, self.DEPTHS[0], self.DEPTHS[-1]))
        return float(np.interp(math.log2(d), self._xs, self._p99))

    def service(self, nbytes: int, queue_depth: int) -> Service:
        if self._iops is None:
            self._calibrate()
        d = float(np.clip(queue_depth, self.DEPTHS[0], self.DEPTHS[-1]))
        x = math.log2(d)
        iops = float(np.interp(x, self._xs, self._iops))
        lat = float(np.interp(x, self._xs, self._lat))
        pages = max(1, math.ceil(nbytes / self.PAGE))
        return Service(occupancy=pages / iops, latency=lat)

    def service_total_batch(self, nbytes: int, depths) -> np.ndarray:
        """Vectorized `service(nbytes, d).total` over an array of queue
        depths — one interp over the calibrated ladder instead of a
        Python call per access. Matches the scalar path value-for-value;
        this is how a control plane prices thousands of queued fetches
        per step without re-entering the model per key. Float64 numpy on
        the host, as the scalar path."""
        if self._iops is None:
            self._calibrate()
        d = np.clip(np.asarray(depths, float),
                    self.DEPTHS[0], self.DEPTHS[-1])
        x = np.log2(d)
        iops = np.interp(x, self._xs, self._iops)
        lat = np.interp(x, self._xs, self._lat)
        pages = max(1, math.ceil(nbytes / self.PAGE))
        return pages / iops + lat


class GpuDirectQueueModel:
    """BaM-style GPU-direct flash path over the calibrated flash ladder.

    Same NAND as `SsdQueueModel` — the calibration is reused, not
    re-run — but a different *path*: the accelerator's submission
    engine enqueues straight into the device SQ from thousands of
    threads, so the device sees a deep queue even when the logical
    in-flight count is small. That is BaM's core performance claim and
    it is what `boost_depth` models: the IOPS/latency ladder is read at
    `max(queue_depth, boost_depth)`, i.e. the device always operates at
    or past the depth where its internal parallelism saturates. On top
    of the device service the path pays only a fixed submission latency
    (`submit_latency`, a doorbell write + completion poll — no host
    DRAM bounce, no host CPU in the loop).

    The economics mirror: `break_even_components_gpu_direct` drops the
    host-CPU and host-DRAM-wire terms from Eq. 1 for the same reason
    this model never touches a host lane. `AsyncTierRuntime` serves a
    store's GPU_FLASH lane with this model.
    """

    def __init__(self, ssd: SsdQueueModel, *, boost_depth: int = 32,
                 submit_latency: float = 3e-6):
        if boost_depth < 1 or submit_latency < 0:
            raise ValueError("invalid GPU-direct parameters")
        self.ssd = ssd
        self.boost_depth = boost_depth
        self.submit_latency = submit_latency

    def _depth(self, queue_depth: int) -> int:
        return max(int(queue_depth), self.boost_depth)

    def service(self, nbytes: int, queue_depth: int) -> Service:
        base = self.ssd.service(nbytes, self._depth(queue_depth))
        return Service(occupancy=base.occupancy,
                       latency=base.latency + self.submit_latency)

    def p99(self, queue_depth: int) -> float:
        return self.ssd.p99(self._depth(queue_depth)) + self.submit_latency
