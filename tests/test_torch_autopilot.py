"""The port's autopilot (reuse sketch, ReuseTracker, EconomicGate,
ProvisionAdvisor, traces, the admission benchmark) against the JAX
reference, on the same seeded numpy inputs.

Bit for bit: the sketch's plain version against the reference's numpy
oracle (`kernels/reuse_sketch/ref.py`), everywhere, bucket edges and
special values included; the tracker's intervals and histogram; the
gate's decisions and counters; the traces; the benchmark's JSON, byte for
byte. rtol 1e-12: break-even thresholds (float64 on both sides).

The reference's Pallas kernel (interpret mode, XLA on the CPU) is held to
the port exactly where XLA's arithmetic allows it: XLA contracts
`decay * hist + counts` into one fused multiply-add, so with a decay
below 1 and a non-zero histogram the two differ by at most one float32
ulp, and XLA's log2 floors a few exact bucket edges one bucket low (the
port follows the oracle, see `test_bucket_edge_follows_the_oracle`). Its
counts are the port's exactly. On the CPU the kernel wrapper takes the
plain version and counts no launch; chip_smoke.py holds the CUDA kernel
to the plain version bit for bit on the card."""
import dataclasses
import pathlib
import re

import numpy as np
import pytest
import torch

from repro.autopilot import EconomicGate as JGate, ReuseTracker as JTracker
from repro.autopilot.advisor import ProvisionAdvisor as JAdvisor
from repro.autopilot.bench import run_scenario as j_run_scenario, \
    run_suite as j_run_suite
from repro.autopilot.gate import default_classify as j_classify
from repro.autopilot.traces import generate as j_generate
from repro.core.economics import GPU_GDDR as J_GPU_GDDR
from repro.core.policy import Tier as JTier, TieringPolicy as JPolicy
from repro.core.ssd_model import storage_next_ssd as j_ssd
from repro.kernels.reuse_sketch.ops import reuse_sketch_update as j_kernel
from repro.kernels.reuse_sketch.ref import \
    reference_reuse_sketch as j_oracle
from repro.obs import bench_json as j_bench_json
from repro.runtime.clock import VirtualClock as JClock
from repro.runtime.service import GpuDirectQueueModel as JGpuDirect, \
    SsdQueueModel as JSsdQueue
from repro.runtime.tiers import TierSpec as JSpec, TieredStore as JStore
from repro_torch import kernels as K
from repro_torch.autopilot import (SCENARIOS, EconomicGate,
                                   ProvisionAdvisor, ReuseTracker,
                                   default_classify, generate)
from repro_torch.autopilot import bench as port_bench
from repro_torch.core.economics import GPU_GDDR
from repro_torch.core.policy import Tier, TieringPolicy
from repro_torch.core.ssd_model import storage_next_ssd
from repro_torch.kernels.reuse_sketch import (bucket_of,
                                              reference_reuse_sketch,
                                              reuse_sketch_update)
from repro_torch.kernels.reuse_sketch.ops import (MAX_CELLS,
                                                  SMALL_MAX_SLOTS,
                                                  small_path)
from repro_torch.obs import bench_json
from repro_torch.runtime import (GpuDirectQueueModel, SsdQueueModel,
                                 TierSpec, TieredStore, VirtualClock)

TAU0 = 1e-3
SMOKE_PARAMS = {"scenarios": list(SCENARIOS), "n_steps": 120,
                "step_time_ms": 250.0, "l_blk_kib": 128.0,
                "dram_frac": 0.35, "alpha_accel": 4.0, "seed": 0}


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.int32)


def _sketch(hist, iv, cls, **kw) -> np.ndarray:
    """The port's wrapper on CPU tensors made from numpy arrays."""
    return reuse_sketch_update(
        torch.from_numpy(np.asarray(hist, np.float32)),
        torch.from_numpy(np.asarray(iv, np.float32)),
        torch.from_numpy(np.asarray(cls, np.int32)), **kw).numpy()


def _segments(rng, n, m, empty_frac):
    """int32 ends of m segments over n slots at seeded random cuts, a share
    `empty_frac` of the segments empty (one-key segments when m == n)."""
    if m == n and not empty_frac:
        return np.arange(1, n + 1, dtype=np.int32)
    cuts = np.sort(rng.integers(0, n + 1, m - 1))
    cuts[rng.random(m - 1) < empty_frac] = 0
    return np.append(np.sort(cuts), n).astype(np.int32)


def _oracle_over_segments(hist, iv, cls, ends, **kw):
    """The reference's numpy oracle applied segment after segment."""
    out, start = np.asarray(hist, np.float32), 0
    for end in ends:
        out = j_oracle(out, iv[start:end], cls[start:end], **kw)
        start = end
    return out


def _log_normal_case(seed, n, c, b):
    """The reference test's draw: log-normal intervals, 15% first-touch
    slots, class ids one past either end of [0, C)."""
    rng = np.random.default_rng(seed)
    hist = (rng.random((c, b)) * 7).astype(np.float32)
    iv = np.exp(rng.normal(0.0, 4.0, n)).astype(np.float32)
    iv[rng.random(n) < 0.15] = 0.0
    cls = rng.integers(-1, c + 1, n).astype(np.int32)
    return hist, iv, cls


def _np_bucket(iv, tau0, n_buckets):
    """The oracle's bucket expression, before the int cast."""
    safe = np.maximum(np.asarray(iv, np.float32), np.float32(1e-30))
    return np.clip(np.floor(np.log2(safe / np.float32(tau0),
                                    dtype=np.float32)), 0, n_buckets - 1)


# ---------------------------------------------------------------------------
# the sketch's plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,n,c,b", [
    (0, 1, 1, 8), (1, 17, 3, 24), (2, 600, 6, 32), (3, 333, 2, 8),
    (4, 512, 5, 24), (5, 64, 4, 32)])
def test_sketch_plain_matches_oracle_bit_for_bit(seed, n, c, b):
    hist, iv, cls = _log_normal_case(seed, n, c, b)
    got = _sketch(hist, iv, cls, tau0=TAU0, decay=0.97)
    want = j_oracle(hist, iv, cls, tau0=TAU0, decay=0.97)
    assert got.dtype == np.float32 and got.shape == (c, b)
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("seed,n,m,empty_frac", [
    (0, 1, 1, 0.0), (1, 600, 1, 0.0), (2, 349, 349, 0.0),
    (3, 10, 10, 0.0), (4, 500, 40, 0.3), (5, 64, 200, 0.5),
    (6, 0, 1, 0.0), (7, 0, 5, 0.0), (8, 2000, 349, 0.1)])
def test_sketch_segments_match_oracle_over_segments(seed, n, m, empty_frac):
    """M batches in one call, bit for bit the reference's oracle looped
    over the same segments: one-key segments (a flush of the tracker),
    random cuts with empty segments among them, and N = 0."""
    hist, iv, cls = _log_normal_case(seed, n, 6, 32)
    rng = np.random.default_rng(100 + seed)
    ends = _segments(rng, n, m, empty_frac)
    assert ends.size == m
    for decay in (0.995, 1.0):
        got = _sketch(hist, iv, cls, tau0=TAU0, decay=decay,
                      ends=torch.from_numpy(ends))
        want = _oracle_over_segments(hist, iv, cls, ends, tau0=TAU0,
                                     decay=decay)
        np.testing.assert_array_equal(_bits(got), _bits(want))
    # one segment is the unsegmented call
    if m == 1:
        np.testing.assert_array_equal(
            _bits(_sketch(hist, iv, cls, tau0=TAU0, decay=0.995,
                          ends=torch.from_numpy(ends))),
            _bits(_sketch(hist, iv, cls, tau0=TAU0, decay=0.995)))


def test_sketch_segments_are_checked():
    hist = torch.zeros(2, 8)
    iv = torch.full((6,), 0.5)
    cls = torch.zeros(6, dtype=torch.int32)
    for bad in ([2, 1, 6], [-1, 6], [3, 5], [], [[6]]):
        with pytest.raises(ValueError, match="ends"):
            reuse_sketch_update(hist, iv, cls, tau0=TAU0, decay=0.9,
                                ends=torch.tensor(bad, dtype=torch.int32))
    n = SMALL_MAX_SLOTS + 1
    big_iv, big_cls = torch.full((n,), 0.5), torch.zeros(n, dtype=torch.int32)
    with pytest.raises(ValueError, match="at most"):
        reuse_sketch_update(hist, big_iv, big_cls, tau0=TAU0, decay=0.9,
                            ends=torch.tensor([1, n], dtype=torch.int32))
    one = reuse_sketch_update(hist, big_iv, big_cls, tau0=TAU0, decay=0.9,
                              ends=torch.tensor([n], dtype=torch.int32))
    assert float(one.sum()) == n


def test_small_path_rule_at_its_limit():
    """The Python twin of `sketch_small_path` (csrc/reuse_sketch.cu):
    the one-block path up to SMALL_MAX_SLOTS slots, the large path from
    one more; the constants are the source's."""
    assert small_path(0) and small_path(SMALL_MAX_SLOTS - 1)
    assert small_path(SMALL_MAX_SLOTS)
    assert not small_path(SMALL_MAX_SLOTS + 1)
    src = (pathlib.Path(__file__).resolve().parents[1] / "src" /
           "repro_torch" / "csrc" / "reuse_sketch.cu").read_text()
    assert re.search(r"kSmallMaxSlots = (\d+);", src).group(1) == \
        str(SMALL_MAX_SLOTS)
    assert re.search(r"kMaxCells = (\d+);", src).group(1) == str(MAX_CELLS)


def test_sketch_empty_batch_decays_only():
    hist = np.full((2, 8), 4.0, np.float32)
    got = _sketch(hist, np.zeros(0), np.zeros(0), tau0=TAU0, decay=0.5)
    np.testing.assert_array_equal(got, 2.0)
    np.testing.assert_array_equal(
        _bits(got), _bits(j_oracle(hist, np.zeros(0), np.zeros(0, np.int32),
                                   tau0=TAU0, decay=0.5)))


@pytest.mark.parametrize("width", [4, 512])
def test_sketch_needs_no_padding(width):
    """The reference pads the batch to a power-of-two width with (0, -1)
    slots for XLA's jit cache; the port compiles no width, and padding
    the batch by hand does not change its result either."""
    hist = np.zeros((2, 16), np.float32)
    iv = np.asarray([0.01, 0.5, 3.0], np.float32)
    cls = np.asarray([0, 1, 0], np.int32)
    pad = width - iv.size
    got = _sketch(hist, iv, cls, tau0=TAU0, decay=1.0)
    padded = _sketch(hist, np.concatenate([iv, np.zeros(pad, np.float32)]),
                     np.concatenate([cls, np.full(pad, -1, np.int32)]),
                     tau0=TAU0, decay=1.0)
    np.testing.assert_array_equal(_bits(got), _bits(padded))
    ref = np.asarray(j_kernel(hist, iv, cls, tau0=TAU0, decay=1.0,
                              batch_pad=width))
    np.testing.assert_array_equal(_bits(got), _bits(ref))
    assert got.sum() == 3.0


@pytest.mark.parametrize("b_lo,b_hi", [(0, 13), (14, 27), (28, 40)])
@pytest.mark.parametrize("tau0", [TAU0, 3e-3, 7e-3])
def test_bucket_of_matches_numpy_at_every_edge(tau0, b_lo, b_hi):
    """Every float32 within 2^12 ulps of tau0 * 2^b: the floor of a
    rounded log2 is not the quotient's exponent there, so this is where
    a bucket rule that differs from the oracle's would show. At 3e-3 and
    7e-3 a multiply by the float32 reciprocal of tau0 (what PyTorch does
    for a CUDA tensor divided by a host scalar) moves some of them."""
    base = np.float32(tau0) * np.exp2(np.arange(b_lo, b_hi + 1)).astype(
        np.float32)
    steps = np.arange(-4096, 4097, dtype=np.int64)
    iv = (base.view(np.int32).astype(np.int64)[:, None]
          + steps[None, :]).astype(np.int32).view(np.float32).ravel()
    got = bucket_of(torch.from_numpy(iv), tau0, 64).numpy()
    np.testing.assert_array_equal(got, _np_bucket(iv, tau0, 64))
    # and the whole update, through the oracle, for a 32-bucket sketch
    cls = np.zeros(iv.size, np.int32)
    hist = np.zeros((1, 32), np.float32)
    np.testing.assert_array_equal(
        _bits(_sketch(hist, iv, cls, tau0=tau0, decay=1.0)),
        _bits(j_oracle(hist, iv, cls, tau0=tau0, decay=1.0)))


def test_bucket_exponent_shortcut_is_the_log2_floor():
    """The kernel takes a quotient's bucket from its float32 exponent e
    when the mantissa is below kFastMantissa (csrc/reuse_sketch.cu), and
    the log2 otherwise. The oracle's floor of a float32 log2 rises with q,
    so it is e on all of a binade's mantissas up to the largest the
    shortcut takes iff it is e there; e < 0 clips to bucket 0."""
    src = (pathlib.Path(__file__).resolve().parents[1] / "src" /
           "repro_torch" / "csrc" / "reuse_sketch.cu").read_text()
    fast = int(re.search(r"kFastMantissa = (0x[0-9A-F]+)u;", src).group(1),
               16)
    e = np.arange(-126, 128)
    top = ((e + 127).astype(np.int64) << 23 | (fast - 1)).astype(
        np.int32).view(np.float32)
    low = ((e + 127).astype(np.int64) << 23).astype(np.int32).view(
        np.float32)
    for q in (top, low):
        floor = np.floor(np.log2(q, dtype=np.float32))
        np.testing.assert_array_equal(np.maximum(floor, 0),
                                      np.maximum(e, 0))
    # and the shortcut stops short of where the floor does move to e + 1
    above = ((e[e >= 0] + 127).astype(np.int64) << 23 | 0x7FFFFF).astype(
        np.int32).view(np.float32)
    assert (np.floor(np.log2(above, dtype=np.float32)) == e[e >= 0] + 1).any()


def test_sketch_special_values():
    f32 = np.finfo(np.float32)
    iv = np.array([0.0, -0.0, -1.0, -1e-9, np.nan, np.inf, -np.inf, 1e-45,
                   1e-40, float(f32.tiny), 1e-30, 1e-9, 1e38,
                   float(f32.max)], np.float32)
    C, B = 3, 32
    cls_set = np.array([-1, 0, 1, C - 1, C], np.int32)
    ivs, clss = np.repeat(iv, cls_set.size), np.tile(cls_set, iv.size)
    hist = np.random.default_rng(9).random((C, B)).astype(np.float32)
    got = _sketch(hist, ivs, clss, tau0=TAU0, decay=0.995)
    with np.errstate(over="ignore", invalid="ignore"):   # FLT_MAX / tau0
        want = j_oracle(hist, ivs, clss, tau0=TAU0, decay=0.995)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    # by hand: +inf and FLT_MAX land in the last bucket, subnormal and
    # tiny positive intervals in bucket 0, the rest is skipped
    counts = _sketch(np.zeros((C, B), np.float32), ivs, clss, tau0=TAU0,
                     decay=1.0)
    want = np.zeros((C, B), np.float32)
    want[:, B - 1] = 3          # +inf, 1e38, FLT_MAX
    want[:, 0] = 5              # 1e-45, 1e-40, tiny, 1e-30, 1e-9
    np.testing.assert_array_equal(counts, want)


def test_bucket_edge_follows_the_oracle():
    """At q = iv / tau0 = 8192 exactly the oracle (and the bucket range
    [tau0 * 2^b, tau0 * 2^(b+1))) says bucket 13; the reference's Pallas
    kernel, run by XLA, computes log2 = 12.999999 and counts bucket 12.
    The port follows the oracle."""
    iv = np.array([np.float32(TAU0) * np.float32(8192.0)], np.float32)
    assert iv[0] / np.float32(TAU0) == np.float32(8192.0)
    assert float(bucket_of(torch.from_numpy(iv), TAU0, 32)[0]) == 13.0
    got = _sketch(np.zeros((1, 32), np.float32), iv, [0], tau0=TAU0,
                  decay=1.0)
    assert got[0, 13] == 1.0 and got.sum() == 1.0
    np.testing.assert_array_equal(
        got, j_oracle(np.zeros((1, 32), np.float32), iv,
                      np.zeros(1, np.int32), tau0=TAU0, decay=1.0))
    pallas = np.asarray(j_kernel(np.zeros((1, 32), np.float32), iv,
                                 np.zeros(1, np.int32), tau0=TAU0,
                                 decay=1.0))
    assert pallas[0, 12] == 1.0        # the reference quirk, recorded


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_sketch_plain_matches_pallas_kernel(seed):
    hist, iv, cls = _log_normal_case(seed, 400, 4, 32)
    # counts alone (zero history): bit for bit
    zero = np.zeros_like(hist)
    np.testing.assert_array_equal(
        _bits(_sketch(zero, iv, cls, tau0=TAU0, decay=0.97)),
        _bits(np.asarray(j_kernel(zero, iv, cls, tau0=TAU0, decay=0.97))))
    # with history and decay 1 the fused multiply-add rounds once either
    # way: bit for bit
    np.testing.assert_array_equal(
        _bits(_sketch(hist, iv, cls, tau0=TAU0, decay=1.0)),
        _bits(np.asarray(j_kernel(hist, iv, cls, tau0=TAU0, decay=1.0))))
    # decay 0.97: XLA's fused multiply-add is within one ulp
    got = _sketch(hist, iv, cls, tau0=TAU0, decay=0.97)
    ref = np.asarray(j_kernel(hist, iv, cls, tau0=TAU0, decay=0.97))
    ulps = np.abs(_bits(got).astype(np.int64) - _bits(ref).astype(np.int64))
    assert ulps.max() <= 1


def test_sketch_wrapper_checks_and_counts_nothing_on_cpu():
    K.reset_launch_counts()
    with pytest.raises(ValueError, match="match in length"):
        reuse_sketch_update(torch.zeros(1, 8), torch.zeros(3),
                            torch.zeros(2, dtype=torch.int32), tau0=TAU0,
                            decay=0.9)
    args = (torch.ones(2, 8), torch.tensor([1.0, 0.1]),
            torch.tensor([0, 1], dtype=torch.int32))
    assert torch.equal(reuse_sketch_update(*args, tau0=TAU0, decay=0.9),
                       reference_reuse_sketch(*args, tau0=TAU0, decay=0.9))
    assert K.launch_counts()["reuse_sketch"] == 0
    with pytest.raises(ValueError, match="all on one CUDA device"):
        reuse_sketch_update(torch.zeros(1, 8, device="meta"),
                            torch.zeros(1), torch.zeros(1, dtype=torch.int32),
                            tau0=TAU0, decay=0.9)


# ---------------------------------------------------------------------------
# ReuseTracker
# ---------------------------------------------------------------------------

def _assert_trackers_equal(pt, jt, classes):
    np.testing.assert_array_equal(_bits(pt.hist.numpy()), _bits(jt.hist))
    assert (pt.observed, pt.measured) == (jt.observed, jt.measured)
    assert len(pt._last_seen) == len(jt._last_seen)
    for cls in classes:
        assert pt.class_quantile(cls) == jt.class_quantile(cls)
        assert pt.class_quantile(cls, 0.9) == jt.class_quantile(cls, 0.9)
        assert pt.class_mass(cls) == jt.class_mass(cls)
        np.testing.assert_array_equal(pt.interval_samples(cls),
                                      jt.interval_samples(cls))
        h, jh = pt.histogram(cls), jt.histogram(cls)
        assert (h is None) == (jh is None)
        if h is not None:
            np.testing.assert_array_equal(_bits(h), _bits(jh))


def _pair_trackers(**kw):
    return ReuseTracker(device="cpu", **kw), JTracker(**kw)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_tracker_applies_pending_observes_at_each_read(seed):
    """One-key observes with class_quantile, seed_prior and histogram
    interleaved at random: the lazily applied sketch has the reference's
    bits at every read, and it is applied once per read that finds
    observes pending (and at no other time)."""
    pt, jt = _pair_trackers(decay=0.97, ghost_capacity=64)
    classes = ["kv", "obj", "scan"]
    for tr in (pt, jt):
        for c in classes:
            tr.class_id(c)
    rng = np.random.default_rng(seed)
    pending, reads_pending, observes, now = False, 0, 0, 0.0
    for _ in range(600):
        now += float(rng.exponential(0.05))
        op = rng.random()
        cls = classes[int(rng.integers(0, 3))]
        if op < 0.8:
            key = (cls, int(rng.integers(0, 40)))
            assert pt.observe(key, cls, now) == jt.observe(key, cls, now)
            pending, observes = True, observes + 1
            continue
        reads_pending += pending
        pending = False
        if op < 0.9:
            q = float(rng.choice([0.1, 0.5, 0.9]))
            assert pt.class_quantile(cls, q) == jt.class_quantile(cls, q)
        elif op < 0.95:
            iv, w = float(rng.uniform(1e-4, 10.0)), float(rng.uniform(0.1, 2))
            pt.seed_prior(cls, iv, w)
            jt.seed_prior(cls, iv, w)
        np.testing.assert_array_equal(_bits(pt.histogram(cls)),
                                      _bits(jt.histogram(cls)))
        assert pt.flushes == reads_pending
    np.testing.assert_array_equal(_bits(pt.hist.numpy()), _bits(jt.hist))
    assert pt.flushes == reads_pending + pending
    assert 0 < pt.flushes < pt.observed == jt.observed == observes


def test_tracker_flushes_at_the_small_path_limit():
    """Pending slots never pass SMALL_MAX_SLOTS: a batch that would is
    applied after the pending ones, and a batch larger than the limit is
    applied alone (the large path); the bits stay the reference's."""
    pt, jt = _pair_trackers(decay=0.99, ghost_capacity=1 << 15)
    rng = np.random.default_rng(11)

    def feed(n, now):
        keys = [int(k) for k in rng.integers(0, 20_000, n)]
        np.testing.assert_array_equal(_bits(pt.observe_batch(keys, "kv", now)),
                                      _bits(jt.observe_batch(keys, "kv", now)))

    feed(SMALL_MAX_SLOTS - 1, 1.0)
    feed(1, 2.0)                           # exactly at the limit: pending
    assert (pt.flushes, pt._n, pt._m) == (0, SMALL_MAX_SLOTS, 2)
    feed(1, 3.0)                           # one past: the two go first
    assert (pt.flushes, pt._n, pt._m) == (1, 1, 1)
    feed(SMALL_MAX_SLOTS + 1, 4.0)         # pending first, then it alone
    assert (pt.flushes, pt._n, pt._m) == (3, 0, 0)
    feed(0, 5.0)                           # an empty batch decays only
    assert (pt.flushes, pt._n, pt._m) == (3, 0, 1)
    np.testing.assert_array_equal(_bits(pt.hist.numpy()), _bits(jt.hist))
    assert pt.flushes == 4


def test_tracker_ghost_measures_reuse_and_bounds_size():
    pt, jt = _pair_trackers(ghost_capacity=4)
    script = [("a", 1.0), ("a", 3.0)] + \
        [(("k", i), 4.0 + i) for i in range(6)] + [("a", 20.0)]
    for key, now in script:
        assert pt.observe(key, "kv", now=now) == jt.observe(key, "kv",
                                                            now=now)
        assert pt.last_seen(key) == jt.last_seen(key)
    assert pt.last_seen(("k", 0)) is None and len(pt._last_seen) <= 4
    _assert_trackers_equal(pt, jt, ["kv", "never"])


def test_tracker_class_quantile_tracks_interval_scale():
    pt, jt = _pair_trackers(tau0=1e-3, decay=1.0)
    for i in range(20):
        for tr in (pt, jt):
            tr.observe("hot", "kv", now=0.1 * i)
            tr.observe("cold", "scan", now=50.0 * i)
    assert 0.05 < pt.class_quantile("kv") < 0.3
    assert pt.class_quantile("scan") > 25.0
    _assert_trackers_equal(pt, jt, ["kv", "scan", "never"])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tracker_batches_match_reference(seed):
    """Random batches of mixed classes, duplicates within a batch, string
    and precomputed-int class forms, and an empty (decay-only) batch."""
    pt, jt = _pair_trackers(decay=0.9, ghost_capacity=64)
    rng = np.random.default_rng(seed)
    for t in range(12):
        ids = rng.integers(0, 40, int(rng.integers(0, 30)))
        keys = [("kv" if i < 20 else "obj", int(i)) for i in ids]
        if t % 3 == 0:
            classes = [k[0] for k in keys]
        elif t % 3 == 1:
            classes = "kv"
        else:
            classes = np.asarray([pt.class_id(k[0]) for k in keys], np.int64)
            for k in keys:
                jt.class_id(k[0])
        now = 0.37 * t + float(rng.random())
        iv = pt.observe_batch(keys, classes, now)
        jiv = jt.observe_batch(keys, classes, now)
        np.testing.assert_array_equal(_bits(iv), _bits(jiv))
        _assert_trackers_equal(pt, jt, ["kv", "obj"])


def test_tracker_ghost_evicts_past_capacity_like_the_reference():
    pt, jt = _pair_trackers(ghost_capacity=50)
    rng = np.random.default_rng(5)
    for t in range(10):
        keys = [int(k) for k in rng.integers(0, 300, 80)]   # > capacity
        np.testing.assert_array_equal(
            _bits(pt.observe_batch(keys, "obj", float(t))),
            _bits(jt.observe_batch(keys, "obj", float(t))))
        assert sorted(pt._last_seen._row) == sorted(jt._last_seen._row)
    _assert_trackers_equal(pt, jt, ["obj"])


def test_tracker_seed_prior_and_forget_keys():
    pt, jt = _pair_trackers(decay=0.99)
    for tr in (pt, jt):
        tr.seed_prior("kv", 0.25, weight=3.0)
        tr.seed_prior("kv", 1e-9)                   # clips to bucket 0
        tr.seed_prior("obj", 1e9, weight=0.5)       # clips to the top
        tr.observe_batch(["a", "b", "c"], "kv", 1.0)
        tr.observe_batch(["a", "b"], "kv", 1.5)
        tr.forget_keys(["a", "zz"])
        tr.observe_batch(["a", "b"], "kv", 2.0)     # "a" is a first touch
    assert pt.last_seen("a") == 2.0 and pt.measured == jt.measured == 3
    _assert_trackers_equal(pt, jt, ["kv", "obj"])
    for bad in (dict(interval=0.0), dict(interval=1.0, weight=0.0)):
        with pytest.raises(ValueError):
            pt.seed_prior("kv", **bad)


@pytest.mark.parametrize("decay", [1.0, 0.9])
def test_tracker_matches_reference_kernel_path(decay):
    """Against the reference tracker with `use_kernel=True` (the Pallas
    kernel): bit for bit at decay 1, within XLA's one-ulp fused
    multiply-add otherwise, with the same measured intervals."""
    pt = ReuseTracker(device="cpu", decay=decay)
    jt = JTracker(use_kernel=True, decay=decay)
    rng = np.random.default_rng(7)
    for t in range(4):
        keys = [("kv", int(i)) for i in rng.integers(0, 12, 16)]
        for tr in (pt, jt):
            tr.observe_batch(keys, ["kv"] * len(keys), now=0.3 * t)
    got, ref = _bits(pt.hist.numpy()), _bits(jt.hist)
    if decay == 1.0:
        np.testing.assert_array_equal(got, ref)
    else:
        assert np.abs(got.astype(np.int64) - ref).max() <= 1
    assert pt.measured == jt.measured > 0


def test_tracker_validation_and_device():
    with pytest.raises(ValueError):
        ReuseTracker(n_buckets=1, device="cpu")
    with pytest.raises(ValueError):
        ReuseTracker(decay=0.0, device="cpu")
    tr = ReuseTracker(max_classes=1, device="cpu")
    tr.observe("a", "kv", now=0.0)
    with pytest.raises(ValueError):
        tr.class_id("another")
    assert tr.hist.device.type == "cpu" and tr.hist.dtype == torch.float32
    assert tr.histogram("never") is None
    np.testing.assert_array_equal(tr.bucket_centers(),
                                  JTracker().bucket_centers())


# ---------------------------------------------------------------------------
# EconomicGate
# ---------------------------------------------------------------------------

def _specs(l=1 << 16):
    return ({Tier.HBM: TierSpec(2 * l, 819e9, 1e-7),
             Tier.DRAM: TierSpec(8 * l, 45e9, 5e-7),
             Tier.FLASH: TierSpec(1 << 30, 7e9, 2e-5)},
            {JTier.HBM: JSpec(2 * l, 819e9, 1e-7),
             JTier.DRAM: JSpec(8 * l, 45e9, 5e-7),
             JTier.FLASH: JSpec(1 << 30, 7e9, 2e-5)})


def _pair_stores(**gate_kw):
    specs, jspecs = _specs()
    gate = EconomicGate(device="cpu", **gate_kw)
    jgate = JGate(**gate_kw)
    return (gate, TieredStore(gate, specs=specs, clock=VirtualClock()),
            jgate, JStore(jgate, specs=jspecs, clock=JClock()))


def _tier_name(store, key):
    t = store.tier_of(key)
    return None if t is None else t.name


def test_gate_cold_default_then_prior_then_measured():
    gate, store, jgate, jstore = _pair_stores(tau_hot=0.01, tau_be=1.0)
    blob = np.zeros(1 << 14, np.uint8)
    script = [("put", ("kv", 0), None)] + \
        [("advance", 0.1, None), ("get", ("kv", 0), None)] * 7 + \
        [("put", ("kv", 1), None), ("delete", ("kv", 1), None),
         ("advance", 0.05, None), ("put", ("kv", 1), None),
         ("put", ("kv", 2), "FLASH"), ("put", ("obj", 3), None)]
    placed = []
    for op, arg, tier in script:
        for s, T in ((store, Tier), (jstore, JTier)):
            if op == "put":
                s.put(arg, blob, **({} if tier is None
                                    else {"tier": T[tier]}))
            elif op == "get":
                s.get(arg)
            elif op == "delete":
                s.delete(arg)
            else:
                s.clock.advance(arg)
        if op != "advance":
            placed.append(_tier_name(store, arg))
            assert placed[-1] == _tier_name(jstore, arg)
        assert dataclasses.asdict(gate.gate_stats) == \
            dataclasses.asdict(jgate.gate_stats)
    assert placed[0] == "FLASH"                 # cold default
    assert placed[8] == "DRAM"                  # class prior
    assert placed[-3:] == ["DRAM", "FLASH", "FLASH"]   # ghost, pin, cold
    st = gate.gate_stats
    assert st.cold_defaults >= 1 and st.prior_decisions >= 1
    assert st.readmits_measured >= 1


def test_gate_default_classify():
    for key in [("kv", "s0"), (3, 7), "plain", (), (1, "x"),
                (np.int64(2), 4), ("tenant_b", 3)]:
        assert default_classify(key) == j_classify(key)


@pytest.mark.parametrize("iv", [0.9, 1.0, 1.1])
def test_gate_no_oscillation_on_constant_interval_trace(iv):
    gate, store, jgate, jstore = _pair_stores(tau_hot=1e-3, tau_be=1.0,
                                              hysteresis=0.25)

    def moves(s):
        return (sum(x.promotions for x in s.stats.values()),
                sum(x.demotions for x in s.stats.values()))

    for s in (store, jstore):
        s.put("k", np.zeros(1 << 14, np.uint8))
    for t in range(40):
        for s in (store, jstore):
            s.clock.advance(iv)
            s.get("k")
        if t == 10:
            base = moves(store)
        assert moves(store) == moves(jstore)
        assert _tier_name(store, "k") == _tier_name(jstore, "k")
    assert moves(store) == base, f"oscillation at interval {iv}"


def test_gate_evicts_stale_squatters_before_active_keys():
    gate = EconomicGate(tau_hot=1e-3, tau_be=10.0, device="cpu")
    jgate = JGate(tau_hot=1e-3, tau_be=10.0)
    for g in (gate, jgate):
        for t in (0.0, 0.5, 1.0):
            g.observe("squatter", now=t)
        for t in np.arange(1.0, 60.0, 2.0):
            g.observe("active", now=float(t))
        for i in range(5):
            g.observe(("kv", i), now=30.0 + 3 * i)
    order = gate.evict_candidates(Tier.DRAM, now=60.0)
    assert order == jgate.evict_candidates(JTier.DRAM, now=60.0)
    assert order.index("squatter") < order.index("active")
    assert gate.evict_candidates(Tier.DRAM, now=60.0, limit=2) == order[:2]
    with pytest.raises(ValueError):
        gate.evict_candidates(Tier.DRAM)
    with pytest.raises(ValueError):
        gate.observe("x")


@pytest.mark.parametrize("kw", [
    {}, dict(alpha_stall=4.0, fetch_seconds=3e-4),
    dict(gamma_rw=3.0, phi_wa=1.5, tau_hot=1e-4),
    dict(iops_ssd=2e6, alpha_stall=1.0, fetch_seconds=1e-3)])
def test_gate_from_break_even_thresholds(kw):
    for l_blk in (4096, 1 << 17):
        gate = EconomicGate.from_break_even(GPU_GDDR, storage_next_ssd(),
                                            l_blk, device="cpu", **kw)
        jgate = JGate.from_break_even(J_GPU_GDDR, j_ssd(), l_blk, **kw)
        assert gate.tau_be == pytest.approx(jgate.tau_be, rel=1e-12)
        assert gate.tau_hot == pytest.approx(jgate.tau_hot, rel=1e-12)
        assert gate.tau_be > 0
    plain = EconomicGate.from_break_even(GPU_GDDR, storage_next_ssd(),
                                         1 << 17, device="cpu")
    priced = EconomicGate.from_break_even(GPU_GDDR, storage_next_ssd(),
                                          1 << 17, alpha_stall=4.0,
                                          fetch_seconds=3e-4, device="cpu")
    assert priced.tau_be > plain.tau_be


def test_gate_pool_gpu_direct_and_class_thresholds():
    kw = dict(tau_hot=0.01, tau_be=1.0, tau_pool=8.0, gpu_direct=True,
              class_tau_be={"premium": 5.0})
    gate = EconomicGate(device="cpu", **kw)
    jgate = JGate(**kw)
    now = 0.0
    events = [("kv", 0), ("kv", 1), ("premium", 0), ("kv", 0), ("kv", 2),
              ("premium", 0), ("kv", 1), ("scan", 0)]
    for i, key in enumerate(events):
        now += [0.2, 1.5, 0.5, 2.0][i % 4]
        for ask in ("DRAM", "FLASH", "HBM"):
            assert gate.pool_admit(key, Tier[ask], now) == \
                jgate.pool_admit(key, JTier[ask], now)
            assert gate.admit_tier(key, Tier[ask], now).name == \
                jgate.admit_tier(key, JTier[ask], now).name
            assert gate.priced_out(key) == jgate.priced_out(key)
        for g in (gate, jgate):
            g.observe(key, now=now)
        assert gate.tau_for(key) == jgate.tau_for(key)
        assert gate.tier_of(key).name == jgate.tier_of(key).name
        assert gate.estimate_interval(key, now) == \
            jgate.estimate_interval(key, now)
    assert dataclasses.asdict(gate.gate_stats) == \
        dataclasses.asdict(jgate.gate_stats)
    assert gate.gate_stats.admits_gpu_flash > 0
    assert gate.gate_stats.admits_pool > 0
    gate.forget_keys([("kv", 0)])
    assert not gate.priced_out(("kv", 0))
    assert gate.tracker.last_seen(("kv", 0)) is None
    with pytest.raises(ValueError, match="tau_pool"):
        EconomicGate(tau_hot=0.01, tau_be=1.0, tau_pool=0.5, device="cpu")


def test_priced_out_restore_is_billed_to_the_gate():
    """A key the gate sends to flash against a DRAM ask: its restore's
    stall lands under gate_miss_restore, as in the reference's ledger; a
    flash-pinned key's restore stays flash_service."""
    gate, store, jgate, jstore = _pair_stores(tau_hot=0.01, tau_be=1.0)
    blob = np.zeros(1 << 14, np.uint8)
    for s, T in ((store, Tier), (jstore, JTier)):
        s.put(("kv", 0), blob)                      # cold: priced out
        s.put(("kv", 1), blob, tier=T.FLASH)        # pinned: no decision
        s.clock.advance(0.5)
        s.get(("kv", 0))
        s.get(("kv", 1))
    assert gate.priced_out(("kv", 0)) and not gate.priced_out(("kv", 1))
    got, ref = store.ledger.totals, jstore.ledger.totals
    assert got["gate_miss_restore"] > 0 and got["flash_service"] > 0
    assert set(got) == set(ref)
    for c in got:
        assert got[c] == pytest.approx(ref[c], rel=1e-12, abs=1e-18)


def test_plain_policy_takes_the_requested_tier():
    """A policy without admit_tier/priced_out keeps the seed behavior."""
    specs, jspecs = _specs()
    store = TieredStore(TieringPolicy(tau_hot=0.01, tau_be=1.0),
                        specs=specs, clock=VirtualClock())
    jstore = JStore(JPolicy(tau_hot=0.01, tau_be=1.0), specs=jspecs,
                    clock=JClock())
    for s, T in ((store, Tier), (jstore, JTier)):
        s.put("a", np.zeros(1 << 14, np.uint8))
        s.put("b", np.zeros(1 << 14, np.uint8), tier=T.FLASH)
        s.clock.advance(0.1)
        s.get("b")
    assert store.tier_of("a") == Tier.DRAM
    assert store.ledger.totals["gate_miss_restore"] == 0.0
    assert store.ledger.totals == pytest.approx(jstore.ledger.totals,
                                                rel=1e-12)


def test_gpu_direct_admission_lands_on_flash_in_a_three_tier_store():
    gate, store, jgate, jstore = _pair_stores(tau_hot=0.01, tau_be=1.0,
                                              gpu_direct=True)
    for s in (store, jstore):
        s.put(("kv", 0), np.zeros(1 << 14, np.uint8))
    assert gate.gate_stats.admits_gpu_flash == 1
    assert store.tier_of(("kv", 0)) == Tier.FLASH
    assert jstore.tier_of(("kv", 0)) == JTier.FLASH


def test_gpu_direct_queue_model_matches_reference():
    ssd, jssd = SsdQueueModel.shared(), JSsdQueue.shared()
    for kw in ({}, dict(boost_depth=8, submit_latency=1e-5)):
        m, jm = GpuDirectQueueModel(ssd, **kw), JGpuDirect(jssd, **kw)
        for nbytes, depth in ((4096, 1), (1 << 17, 4), (1 << 20, 64)):
            s, js = m.service(nbytes, depth), jm.service(nbytes, depth)
            assert s.occupancy == pytest.approx(js.occupancy, rel=1e-12)
            assert s.latency == pytest.approx(js.latency, rel=1e-12)
            assert m.p99(depth) == pytest.approx(jm.p99(depth), rel=1e-12)
    with pytest.raises(ValueError):
        GpuDirectQueueModel(ssd, boost_depth=0)


# ---------------------------------------------------------------------------
# traces and the admission benchmark
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", SCENARIOS)
def test_traces_identical_to_reference(name):
    for n_steps, seed in ((60, 3), (240, 0)):
        t = generate(name, n_steps=n_steps, seed=seed)
        jt = j_generate(name, n_steps=n_steps, seed=seed)
        assert t.steps == jt.steps and t.step_time == jt.step_time
        assert t.distinct_keys() == jt.distinct_keys()
        assert t.accesses == jt.accesses > 0
    with pytest.raises(ValueError):
        generate("nope")


def test_suite_json_byte_identical_to_reference_smoke():
    """`run_suite` at the reference's `--smoke` settings on the CPU,
    written through `bench_json` with the script's params block: the
    same bytes as benchmarks/serving_autopilot.py --smoke."""
    report = port_bench.run_suite(n_steps=120, device="cpu")
    report["params"] = dict(SMOKE_PARAMS)
    ref = j_run_suite(n_steps=120)
    ref["params"] = dict(SMOKE_PARAMS)
    assert bench_json(report) == j_bench_json(ref)
    assert report["wins"] == 3 and report["cells"] == 4


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_economic_run_observes_every_access_once(scenario, monkeypatch):
    made = []
    init = ReuseTracker.__init__

    def spy(self, *a, **kw):
        init(self, *a, **kw)
        made.append(self)

    monkeypatch.setattr(ReuseTracker, "__init__", spy)
    rec = port_bench.run_scenario(scenario, "economic", n_steps=60,
                                  device="cpu")
    jrec = j_run_scenario(scenario, "economic", n_steps=60)
    assert bench_json(rec) == j_bench_json(jrec)
    (tracker,) = made
    assert tracker.observed == rec["accesses"] == len(
        [k for s in generate(scenario, n_steps=60).steps for k in s])
    # the observes are applied in batches, one call per read of the sketch
    assert 0 < tracker.flushes < tracker.observed


def test_bench_modes_and_best_static():
    cell = port_bench.compare_scenario("zipf", n_steps=40, seed=0,
                                       device="cpu")
    assert cell["best_static"] in ("dram", "flash")
    assert set(cell["runs"]) == {"economic", "dram", "flash"}
    with pytest.raises(ValueError):
        port_bench.run_scenario("zipf", "lru", n_steps=10, device="cpu")
    rates = port_bench.pricing_rates(GPU_GDDR, storage_next_ssd())
    from repro.autopilot.bench import pricing_rates as j_rates
    jr = j_rates(J_GPU_GDDR, j_ssd())
    assert rates == pytest.approx(jr, rel=1e-12)


def test_bench_json_matches_reference_writer():
    obj = {"b": [np.float32(0.1), np.int64(3), float("nan"), -np.inf],
           "a": {"x": np.arange(3), "y": 1.0 / 3.0, "z": True},
           "c": (np.bool_(False), 2.5e-310, 123456789.123456789)}
    assert bench_json(obj) == j_bench_json(obj)


# ---------------------------------------------------------------------------
# ProvisionAdvisor
# ---------------------------------------------------------------------------

def _assert_close_tree(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _assert_close_tree(a[k], b[k])
    elif isinstance(a, float) and not np.isnan(a):
        assert a == pytest.approx(b, rel=1e-12, abs=1e-300)
    elif isinstance(a, float):
        assert np.isnan(b)
    else:
        assert a == b


def _advised_pair():
    specs, jspecs = _specs()
    store = TieredStore(TieringPolicy(tau_hot=1e-12, tau_be=1e-9,
                                      ema_alpha=1.0),
                        specs=specs, clock=VirtualClock())
    jstore = JStore(JPolicy(tau_hot=1e-12, tau_be=1e-9, ema_alpha=1.0),
                    specs=jspecs, clock=JClock())
    pt, jt = ReuseTracker(device="cpu"), JTracker()
    blob = np.zeros(1 << 14, np.uint8)
    for s, T in ((store, Tier), (jstore, JTier)):
        for i in range(6):
            s.put(("kv", i), blob, tier=T.DRAM)
        for i in range(3):
            s.put(("scan", i), blob, tier=T.FLASH)
        s.put("loose", blob, tier=T.FLASH)
    for t in range(1, 6):
        for tr in (pt, jt):
            for i in range(6):
                tr.observe(("kv", i), "kv", now=0.2 * t + 0.01 * i)
            tr.observe(("scan", t), "scan", now=30.0 * t)
    store.clock.advance(31.0)
    jstore.clock.advance(31.0)
    return store, jstore, pt, jt


@pytest.mark.parametrize("kw", [{}, dict(active_window=2.0),
                                dict(dram_bytes_per_host=1 << 15,
                                     headroom=2.0)])
def test_advise_matches_reference(kw):
    store, jstore, pt, jt = _advised_pair()
    adv = ProvisionAdvisor(GPU_GDDR, storage_next_ssd(), 1 << 14, **kw)
    jadv = JAdvisor(J_GPU_GDDR, j_ssd(), 1 << 14, **kw)
    got = adv.advise(pt, store=store)
    ref = jadv.advise(jt, store=jstore)
    _assert_close_tree(got.as_dict(), ref.as_dict())
    assert got.report() == ref.report()
    assert got.bandwidth_limited == ref.bandwidth_limited
    assert "rebalance" not in got.as_dict()
    with pytest.raises(NotImplementedError, match="Queue 1 item 0"):
        adv.advise(pt, fabric=object())
    with pytest.raises(ValueError):
        adv.advise(pt)


@pytest.mark.parametrize("mttf", [3600.0, 1e6, 1e9])
def test_advise_availability_matches_reference(mttf):
    adv = ProvisionAdvisor(GPU_GDDR, storage_next_ssd(), 1 << 17)
    jadv = JAdvisor(J_GPU_GDDR, j_ssd(), 1 << 17)
    kw = dict(resident_bytes=3e10, n_hosts=4, dram_fraction=0.4, mttf=mttf,
              put_bytes_per_second=2e8)
    got = adv.advise_availability(**kw)
    ref = jadv.advise_availability(**kw)
    _assert_close_tree(got.as_dict(), ref.as_dict())
    assert got.report() == ref.report()
    with pytest.raises(NotImplementedError, match="Queue 1 item 0"):
        adv.advise_availability(fabric=object(), mttf=mttf)
    with pytest.raises(ValueError):
        adv.advise_availability(mttf=mttf)


@pytest.mark.parametrize("source", ["tracker", "samples", "empty"])
def test_advise_tiers_matches_reference(source):
    _, _, pt, jt = _advised_pair()
    adv = ProvisionAdvisor(GPU_GDDR, storage_next_ssd(), 1 << 17)
    jadv = JAdvisor(J_GPU_GDDR, j_ssd(), 1 << 17)
    kw = dict(access_rate=5e4, resident_bytes=2e10)
    if source == "tracker":
        got = adv.advise_tiers(pt, **kw)
        ref = jadv.advise_tiers(jt, **kw)
    else:
        samples = (np.geomspace(1e-3, 1e3, 200) if source == "samples"
                   else np.zeros(0))
        got = adv.advise_tiers(interval_samples=samples, **kw)
        ref = jadv.advise_tiers(interval_samples=samples, **kw)
    _assert_close_tree(got.as_dict(), ref.as_dict())
    assert got.report() == ref.report()


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_need_a_device_without_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ReuseTracker()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        EconomicGate(tau_hot=0.01, tau_be=1.0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        EconomicGate.from_break_even(GPU_GDDR, storage_next_ssd(), 1 << 17)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_bench.run_scenario("zipf", "dram", n_steps=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_bench.run_suite(["zipf"], n_steps=4)
    # a caller-built tracker decides the device of a gate
    gate = EconomicGate(tau_hot=0.01, tau_be=1.0,
                        tracker=ReuseTracker(device="cpu"))
    assert gate.tracker.hist.device.type == "cpu"
