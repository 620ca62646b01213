#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (`src/repro_torch`) on one GPU.

Drives the port's serving path on the card and checks it, in phases:

  1. the card's name and power limit (exits non-zero without CUDA);
  2. builds the hand-written CUDA kernels from `src/repro_torch/csrc`;
  3. holds each kernel against its plain PyTorch version on the card at
     the serving path's shapes (float32 and bfloat16, ragged lengths, a
     GQA case beside gemma's MQA, flash attention at head dims 16, 32 and
     112 that its wrapper pads) and times kernel, plain version, one
     PyTorch library call and the roofline bound; flash attention checked
     and timed at every prefill bucket phase 4 hits, in the prefill's own
     strided layout too; decode attention also at lengths 0 and past T,
     behind NaN/inf unfilled rows, at head dims 16, 32, 100 and 112, two
     calls bit-identical, right after a call with other lengths, and its
     per-phase timeline; rmsnorm and add_rmsnorm (the residual add fused
     into the norm) in f32 and bf16 at D = 64 to 8192 and one D that is
     not a multiple of 8, rows 1, 4 and 1023, [1, 1023, D] and views at
     an odd element offset, the fused entry bit for bit against
     rmsnorm(x + r) and x + r, the card's launch plan against the Python
     twin, both entries timed at a decode step's and a prefill's rows,
     the wrapper's host time split into its parts, and the kernel's time
     against the rows a block takes;
  4. full-width gemma-2b (random bf16 weights from a seed, full depth)
     serves 6 requests through `DecodeEngine`, then parks two sessions
     through a `TieredStore` whose DRAM holds 1.5 KV blobs, so the colder
     one is demoted to flash and comes back through a prefetch on the
     virtual clock; every serving kernel's launch counter must move, and
     a prefill and a decode step each make 37 rmsnorm launches; then
     one prefill and one decode step under torch.profiler: device
     operations by time, their count and the device-idle share, and one
     decode-attention kernel with one launch a layer in the step;
  5. reduced gemma-2b in float32: the engine's greedy tokens (kernels)
     equal a greedy loop over the plain PyTorch path;
  6. the SSD-resident cuckoo KV store (paper §VII-A): examples/
     kvstore_demo.py's store (8192 buckets x 8 slots, load 0.7) answers
     4096 batched GETs through the probe kernel and a timed store's
     get_many; then a table of 2^23 buckets x 8 slots (512 MiB on the
     card, each bucket's keys and values in one 64-byte row) answers 2^20
     probes, half stored and half absent; the kernel is held bit for bit
     against its plain version there and on every path (slots 4, 5, 8
     and 16; two arrays, one table, one at a 4-byte offset; N = 0 to
     4096 around a group's edges; one bucket; negative keys; the tests'
     hand-made table and the int32 wrap), its launch plan against the
     Python twin, and it is timed on both layouts, at a table inside L2
     too, beside torch.index_select of the same rows;
  7. two-stage ANN search (paper §VII-B) over 262,144 vectors (full
     1024-d, reduced 128-d) for 1024 queries: recall@10 against exact
     search on the card, ann_topk against its plain version (k = 64, 128
     and 256; exact ties of copied rows across tile and split borders,
     resolved to the lowest ids; N = 300 at k = 256 and k = N; Q = 1 and
     65; D = 30 and 1024; a bitwise repeat), the resident blocks an SM
     the card reports against the shared-memory rule, recall@10 > 0.98 at
     the reference tests' size (8000 vectors), recall@10 at promote 128
     and 256 (and at 256 with stage 1 by exact search), kernel time at
     k = 1, 64, 128 and 256 against torch.addmm + torch.topk, and the
     kernel's per-phase timeline;
  8. the autopilot: the reuse-sketch kernel bit for bit against its plain
     version (on the card and on the host) at the bench's shape, the
     scale replay's (50,000 and 2^20 intervals), an empty batch, every
     bucket edge +-64 ulps and special values; M batches in one call
     (M = 2, 10 and 349 one-key segments, random cuts with empty
     segments, the small path's limit and one slot past it), the large
     path right after itself, bitwise repeats, and one segment whose end
     stops short of N on both paths; times at each flush size; the admission
     benchmark (4 scenarios x 240 steps) on the card, byte-identical to
     the same suite on the CPU, with one kernel launch per flush of a
     tracker's pending observes; and a control plane of 20 steps x
     50,000 Zipf keys over 1,000,000 ids whose sketch is bit-identical on
     the card and the host every step.

The line before the last is the kernels' JSON record; the last line is
`{"ok": true, "device": {...}}`. Any failed check raises, and the script
exits non-zero.

    python3 chip_smoke.py
"""
from __future__ import annotations

import ctypes
import json
import math
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

SEED = 0
N_REQUESTS = 6
MAX_NEW = 16
MAX_SLOTS = 4
MAX_LEN = 1024
STEP_TIME = 5e-3
SPIN_CYCLES = 100_000_000      # ~50 ms at the H100's ~2 GHz SM clock
# kernel vs plain version: both accumulate in float32; float32 outputs
# differ only by summation order, bfloat16 outputs additionally by one
# rounding step of the output (2^-8 relative)
TOL = {"float32": dict(atol=1e-4, rtol=1e-4),
       "bfloat16": dict(atol=3e-2, rtol=1.6e-2)}
KERNELS = {
    "rmsnorm": ("src/repro_torch/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm/kernel.py:29"),
    "decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention/kernel.py:91"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/kernel.py:100"),
    "cuckoo_probe": ("src/repro_torch/csrc/cuckoo_probe.cu",
                     "src/repro/kernels/cuckoo_probe/kernel.py:70"),
    "ann_topk": ("src/repro_torch/csrc/ann_topk.cu",
                 "src/repro/kernels/ann_topk/kernel.py:80"),
    "reuse_sketch": ("src/repro_torch/csrc/reuse_sketch.cu",
                     "src/repro/kernels/reuse_sketch/kernel.py:54"),
}
SERVING_KERNELS = ("rmsnorm", "decode_attention", "flash_attention")
# phase 3, rmsnorm: d_model of the repo's configs (64: the reduced ones),
# the TPU kernel's largest and one that is not a multiple of 8; rows of a
# step, of a decode step's slots and of the largest prefill bucket
RMS_DS = (64, 1536, 2048, 4096, 5120, 6144, 8192, 2050)
RMS_ROWS = (1, MAX_SLOTS, MAX_LEN - 1)
# phase 6: examples/kvstore_demo.py's store, and one at deployment size
KV_DEMO_BUCKETS = 8192
KV_BUCKETS = 1 << 23           # x 8 slots x (key + value) int32 = 512 MiB
KV_SLOTS = 8
KV_LOAD = 0.7
KV_PROBES = 1 << 20
KV_L2_BUCKETS = 1 << 19        # x 8 x 2 x 4 B = 32 MiB: inside the 50 MB L2
# phase 7: the corpus and queries; the reference tests' size
ANN_N, ANN_D_FULL, ANN_D_RED, ANN_Q = 262_144, 1024, 128, 1024
ANN_PROMOTE, ANN_K = 64, 10
ANN_DEEP = (128, 256)          # deeper promotes, up to ann_topk's cap
ANN_SMALL = (8000, 100)
# rows copied from a pool, for exact ties: (corpus rows, pool rows, queries)
ANN_TIED = (65_536, 512, 256)
# ann_topk vs its plain version: float32 products in another summation
# order differ by ~1e-6 at these magnitudes (|d| <= 3); ids are compared
# wherever the plain version's neighbouring distances differ by > 1e-5
ANN_ATOL, ANN_TIE = 1e-4, 1e-5
# phase 8: the scale replay's step (src/repro/serving/scale.py) and the
# control plane fed with it: Zipf ids, the first PLANE_KV of class "kv"
SKETCH_N_STEP = 50_000
PLANE_STEPS, PLANE_KEYS, PLANE_KV = 20, 1_000_000, 100_000


def _prompts(vocab: int, n: int, rng):
    import numpy as np
    return [rng.integers(1, vocab, int(rng.integers(64, 701))).astype(
        np.int32) for _ in range(n)]


def _time_ms(calls, iters: int = 40, queued: bool = True) -> float:
    """Mean time of one call over `iters` calls cycling through `calls`
    (distinct inputs, so a call does not find the previous call's inputs
    in L2 where the real path would find them cold), by CUDA events.

    queued=True gives device time: the calls are enqueued behind a spin
    kernel of ~50 ms, so the host's launch overhead overlaps it and the
    events see only the device work. queued=False lets the host launch
    as the path does, so host overhead shows where it exceeds the work."""
    import torch
    for c in calls[:3]:
        c()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for i in range(iters):
        calls[i % len(calls)]()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _bound_ms(nbytes: float, flops: float, dtype) -> tuple:
    import torch
    from repro_torch.core import units
    peak = (units.H100_PEAK_FLOPS_BF16 if dtype == torch.bfloat16
            else units.H100_PEAK_FLOPS_F32)
    t_bytes = nbytes / units.H100_HBM_BW * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _check(name, got, want, dtype_name, label):
    import torch
    err = float((got.float() - want.float()).abs().max())
    torch.testing.assert_close(got.float(), want.float(),
                               **TOL[dtype_name],
                               msg=lambda m: f"{name} {label}: {m}")
    print(f"  check {name:17s} {label:44s} max_abs_err={err:.3e} ok")
    return err


# ---------------------------------------------------------------- phase 3
def _rmsnorm_cases(eps):
    """rmsnorm and add_rmsnorm against their plain versions (TOL) at every
    D of the repo's configs (64 reduced; 1536 to 6144), the TPU kernel's
    largest (8192) and one that is not a multiple of 8, at rows 1, 4 and
    1023, leading dims [1, 1023, D], and views at an odd element offset
    (the scalar path); bit for bit, the fused normed against rmsnorm(x + r)
    and the sum against x + r, a misaligned row against the same row
    aligned, and a batch's first rows against those rows alone; the plan
    the card takes against ops.launch_plan. Returns the largest errors."""
    import torch
    from repro_torch.kernels import _build, add_rmsnorm, rmsnorm
    from repro_torch.kernels._wrap import DTYPE_CODES
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.kernels.rmsnorm.ref import (reference_add_rmsnorm,
                                                 reference_rmsnorm)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    plan_of = _build.library("rmsnorm_plan_of")
    errs = {}
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[1]
        for D in RMS_DS:
            s = 1.0 + 0.1 * torch.randn(D, generator=gen, device=dev)

            def fresh(*shape, offset=0):
                n = math.prod(shape)
                flat = torch.randn(n + offset, generator=gen, device=dev)
                return flat.to(dt)[offset:].view(shape)

            cases = [((rows, D), 0) for rows in RMS_ROWS]
            cases += [((1, RMS_ROWS[-1], D), 0), ((4, D), 1),
                      ((RMS_ROWS[-1], D), 1)]
            worst = [0.0, 0.0]
            for shape, offset in cases:
                x, r = fresh(*shape, offset=offset), \
                    fresh(*shape, offset=offset)
                label = f"{list(shape)} {name}" + (
                    " odd offset" if offset else "")
                got = rmsnorm(x, s, eps)
                normed, summed = add_rmsnorm(x, r, s, eps)
                want_n, want_s = reference_add_rmsnorm(x, r, s, eps)
                for i, (g, w, lab) in enumerate(
                        ((got, reference_rmsnorm(x, s, eps), "rmsnorm"),
                         (normed, want_n, "add_rmsnorm"))):
                    e = float((g.float() - w.float()).abs().max())
                    torch.testing.assert_close(
                        g.float(), w.float(), **TOL[name],
                        msg=lambda m: f"{lab} {label}: {m}")
                    worst[i] = max(worst[i], e)
                assert torch.equal(summed, x + r), f"sum {label}"
                assert torch.equal(summed, want_s), f"sum {label}"
                assert torch.equal(normed, rmsnorm(x + r, s, eps)), \
                    f"fused != unfused {label}"
                if offset:
                    assert torch.equal(got, rmsnorm(x.clone(), s, eps)), \
                        f"path changed the bits {label}"
                rows = x.numel() // D
                if rows > 4:
                    assert torch.equal(got.view(rows, D)[:4], rmsnorm(
                        x.view(rows, D)[:4].clone(), s, eps)), \
                        f"batch changed the bits {label}"
                aligned = offset == 0
                plan = (ctypes.c_longlong * 5)()
                plan_of(rows, D, DTYPE_CODES[dt], int(aligned), plan)
                want = rms_ops.launch_plan(rows, D, x.element_size(),
                                           aligned, n_sm)
                assert list(plan) == [
                    want["row_threads"], want["chunks"], want["rows"],
                    want["blocks"], int(want["path"] == "vector")], \
                    (label, list(plan), want)
            big = rms_ops.launch_plan(RMS_ROWS[-1], D, x.element_size(),
                                      True, n_sm)
            errs[(dt, D)] = worst
            print(f"  check rmsnorm D={D:<5d} {name:8s} {len(cases)} shapes: "
                  f"max_abs_err {worst[0]:.3e}, fused {worst[1]:.3e}; "
                  f"fused == rmsnorm(x + r) and sum == x + r bitwise; "
                  f"plan at 1023 rows {big['row_threads']} threads a row x "
                  f"{big['chunks']} chunks, {big['rows']} rows a block, "
                  f"{big['path']}")
    return errs


def _host_us(fn, n: int = 2000) -> float:
    """Host time of one call over n calls, synchronised at the end."""
    import torch
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / n * 1e6


def _rmsnorm_host_split(D, eps):
    """Where a decode-step call's host time goes ([4, D] bf16): the whole
    wrapper, its checks, the output's allocation, the stream lookup, the
    ctypes call with everything prepared, and F.rms_norm with its launch."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import _build, _wrap, add_rmsnorm, rmsnorm
    from repro_torch.kernels.rmsnorm import ops as rms_ops

    x = torch.randn(MAX_SLOTS, D, device="cuda").to(torch.bfloat16)
    r = torch.randn(MAX_SLOTS, D, device="cuda").to(torch.bfloat16)
    s = torch.ones(D, device="cuda")
    s16 = s.to(torch.bfloat16)
    out = torch.empty_like(x)
    fn = _build.library("rmsnorm")
    args = (x.data_ptr(), None, s.data_ptr(), out.data_ptr(), None,
            MAX_SLOTS, D, float(eps), 1, _wrap.stream_of(x.device))
    split = {
        "wrapper": _host_us(lambda: rmsnorm(x, s, eps)),
        "fused wrapper": _host_us(lambda: add_rmsnorm(x, r, s, eps)),
        "checks": _host_us(lambda: (_wrap.on_cuda("rmsnorm", x, s),
                                    rms_ops.check_args("rmsnorm", x, None,
                                                       s))),
        "empty_like": _host_us(lambda: torch.empty_like(x)),
        "stream_of": _host_us(lambda: _wrap.stream_of(x.device)),
        # the lookup stream_of made before (a torch.cuda.Stream a call)
        "stream_of before": _host_us(
            lambda: torch.cuda.current_stream(x.device).cuda_stream),
        "ctypes call": _host_us(lambda: fn(*args)),
        "F.rms_norm": _host_us(lambda: F.rms_norm(x, (D,), s16, eps)),
        "x + r": _host_us(lambda: x + r),
    }
    print(f"  host  rmsnorm x [{MAX_SLOTS},{D}] bf16, us a call (host "
          f"clock over 2000 calls): " + ", ".join(
              f"{k} {v:.2f}" for k, v in split.items()))
    return split


def _rmsnorm_times(D, eps, rows):
    """Device, with-launch, plain and library times and the byte bound of
    both entries at [rows, D] bf16; the fused entry also against the
    two launches it replaces (x + r, then the kernel)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import add_rmsnorm, rmsnorm
    from repro_torch.kernels.rmsnorm.ref import (reference_add_rmsnorm,
                                                 reference_rmsnorm)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    n_in = 8 if rows <= MAX_SLOTS else 4
    xs = [(torch.randn(rows, D, generator=gen, device=dev).to(
        torch.bfloat16), torch.randn(rows, D, generator=gen,
                                     device=dev).to(torch.bfloat16))
          for _ in range(n_in)]
    s = 1.0 + 0.1 * torch.randn(D, generator=gen, device=dev)
    s16 = s.to(torch.bfloat16)
    row_bytes = rows * D * 2
    out = {}
    for entry, calls in (
            ("rmsnorm", dict(
                kernel=[lambda x=x: rmsnorm(x, s, eps) for x, _ in xs],
                plain=[lambda x=x: reference_rmsnorm(x, s, eps)
                       for x, _ in xs],
                library=[lambda x=x: F.rms_norm(x, (D,), s16, eps)
                         for x, _ in xs])),
            ("add_rmsnorm", dict(
                kernel=[lambda x=x, r=r: add_rmsnorm(x, r, s, eps)
                        for x, r in xs],
                plain=[lambda x=x, r=r: reference_add_rmsnorm(x, r, s, eps)
                       for x, r in xs],
                library=[lambda x=x, r=r: F.rms_norm(x + r, (D,), s16, eps)
                         for x, r in xs],
                unfused=[lambda x=x, r=r: rmsnorm(x + r, s, eps)
                         for x, r in xs]))):
        n_io = 2 if entry == "rmsnorm" else 4
        b_ms, b_by = _bound_ms(n_io * row_bytes + D * 4,
                               (4 if entry == "rmsnorm" else 5) * rows * D,
                               torch.bfloat16)
        t = dict(ms=_time_ms(calls["kernel"]),
                 launch_ms=_time_ms(calls["kernel"], queued=False),
                 plain_ms=_time_ms(calls["plain"]),
                 library_ms=_time_ms(calls["library"]),
                 bound_ms=b_ms, bound_by=b_by)
        if "unfused" in calls:
            t["unfused_ms"] = _time_ms(calls["unfused"])
            t["unfused_launch_ms"] = _time_ms(calls["unfused"],
                                              queued=False)
        lib = ("F.rms_norm" if entry == "rmsnorm"
               else "x + r, then F.rms_norm: two calls")
        extra = ("" if "unfused_ms" not in t else
                 f" unfused (x + r, then the kernel) {t['unfused_ms']:.6f} "
                 f"(with host launch {t['unfused_launch_ms']:.6f})")
        print(f"  time  {entry:17s} x [{rows},{D}] bf16: kernel_ms="
              f"{t['ms']:.6f} (with host launch {t['launch_ms']:.6f}) "
              f"plain_ms={t['plain_ms']:.6f} library_ms="
              f"{t['library_ms']:.6f} ({lib}) bound_ms={b_ms:.7f} "
              f"({b_by}){extra}")
        out[entry] = t
    return out


def phase_kernels(cfg, lengths_main, buckets):
    """Kernel vs plain version on the card; returns {name: record}.
    `buckets` are phase 4's prefill lengths, the largest the main shape."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import (decode_attention, flash_attention,
                                     rmsnorm)
    from repro_torch.kernels.decode_attention import \
        timeline as decode_timeline
    from repro_torch.kernels.decode_attention.ref import \
        reference_decode_attention
    from repro_torch.kernels.flash_attention.ref import reference_attention
    from repro_torch.kernels.rmsnorm.ref import reference_rmsnorm

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    attn = cfg.pattern[0][0]
    D, H, KV, hd = cfg.d_model, attn.n_heads, attn.n_kv, attn.head_dim
    eps = cfg.norm_eps
    scale = 1.0 / math.sqrt(hd)
    S_main = max(buckets)

    def randn(*shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    rec = {}
    # ---- rmsnorm: decode rows (B) and prefill rows (bucket) -------------
    errs = {}
    for dt in (torch.float32, torch.bfloat16):
        for rows in (MAX_SLOTS, S_main):
            x = randn(rows, D, dtype=dt)
            s = 1.0 + 0.1 * randn(D, dtype=torch.float32)
            errs[(dt, rows)] = _check(
                "rmsnorm", rmsnorm(x, s, eps), reference_rmsnorm(x, s, eps),
                str(dt).split(".")[1], f"[{rows},{D}] {dt}")
    xs = [randn(MAX_SLOTS, D, dtype=torch.bfloat16) for _ in range(8)]
    s = torch.ones(D, device=dev)
    s16 = s.to(torch.bfloat16)
    nbytes = 2 * MAX_SLOTS * D * 2 + D * 4
    b_ms, b_by = _bound_ms(nbytes, 4 * MAX_SLOTS * D, torch.bfloat16)
    rec["rmsnorm"] = dict(
        shape=f"x [{MAX_SLOTS},{D}] bf16 (decode step)",
        max_abs_err=errs[(torch.bfloat16, MAX_SLOTS)],
        ms=_time_ms([lambda x=x: rmsnorm(x, s, eps) for x in xs]),
        launch_ms=_time_ms([lambda x=x: rmsnorm(x, s, eps) for x in xs],
                           queued=False),
        plain_ms=_time_ms([lambda x=x: reference_rmsnorm(x, s, eps)
                           for x in xs]),
        library_ms=_time_ms([lambda x=x: F.rms_norm(x, (D,), s16, eps)
                             for x in xs]),
        bound_ms=b_ms, bound_by=b_by)
    xp = [randn(S_main, D, dtype=torch.bfloat16) for _ in range(4)]
    k_ms = _time_ms([lambda x=x: rmsnorm(x, s, eps) for x in xp])
    p_ms = _time_ms([lambda x=x: reference_rmsnorm(x, s, eps) for x in xp])
    l_ms = _time_ms([lambda x=x: F.rms_norm(x, (D,), s16, eps) for x in xp])
    b_ms = _bound_ms(2 * S_main * D * 2 + D * 4, 4 * S_main * D,
                     torch.bfloat16)[0]
    print(f"  time  rmsnorm           x [{S_main},{D}] bf16 (prefill): "
          f"kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} library_ms={l_ms:.4f} "
          f"bound_ms={b_ms:.5f} (bytes)")
    _rmsnorm_cases(eps)
    _rmsnorm_times(D, eps, MAX_SLOTS)
    _rmsnorm_times(D, eps, S_main)
    _rmsnorm_host_split(D, eps)

    # ---- decode attention: gemma MQA and a GQA case, ragged lengths ------
    ragged = torch.tensor([1, 77, 700, MAX_LEN], dtype=torch.int32,
                          device=dev)
    for dt in (torch.float32, torch.bfloat16):
        for h_, kv_ in ((H, KV), (8, 2)):
            q = randn(MAX_SLOTS, h_, hd, dtype=dt)
            k = randn(MAX_SLOTS, kv_, MAX_LEN, hd, dtype=dt)
            v = randn(MAX_SLOTS, kv_, MAX_LEN, hd, dtype=dt)
            for lens, lab in ((ragged, "ragged"), (lengths_main, "main")):
                errs[(dt, h_, kv_, lab)] = _check(
                    "decode_attention",
                    decode_attention(q, k, v, lens, scale=scale),
                    reference_decode_attention(q, k, v, lens, scale=scale),
                    str(dt).split(".")[1],
                    f"H={h_} KV={kv_} T={MAX_LEN} {lab} {dt}")
    # lengths 0 and past T; unfilled rows NaN in k and inf in v; phase 5's
    # head_dim 32 in f32, 16 and 112 in bf16, and 100, whose rows are not
    # 16-byte multiples (the kernel copies their unaligned ends itself)
    edge = torch.tensor([0, 5, MAX_LEN + 100, 300], dtype=torch.int32,
                        device=dev)
    red = torch.tensor([5, 64, 17, 30], dtype=torch.int32, device=dev)
    for dt, h_, kv_, T_, d_, lens, tail, lab in (
            (torch.float32, H, KV, MAX_LEN, hd, edge, False, "0 and > T"),
            (torch.bfloat16, H, KV, MAX_LEN, hd, edge, False, "0 and > T"),
            (torch.float32, H, KV, MAX_LEN, hd, lengths_main, True,
             "NaN/inf tail"),
            (torch.bfloat16, 8, 2, MAX_LEN, hd, ragged, True, "NaN/inf tail"),
            (torch.float32, 4, 1, 64, 32, red, False, "phase 5 shape"),
            (torch.bfloat16, 8, 2, MAX_LEN, 16, ragged, False, "hd 16"),
            (torch.bfloat16, 8, 2, MAX_LEN, 112, edge, False, "hd 112"),
            (torch.bfloat16, H, KV, MAX_LEN - 1, 100, ragged, False,
             "hd 100")):
        q = randn(MAX_SLOTS, h_, d_, dtype=dt)
        k = randn(MAX_SLOTS, kv_, T_, d_, dtype=dt)
        v = randn(MAX_SLOTS, kv_, T_, d_, dtype=dt)
        if tail:
            unfilled = (torch.arange(T_, device=dev)[None, :]
                        >= lens[:, None])[:, None, :, None]
            k = k.masked_fill(unfilled, float("nan"))
            v = v.masked_fill(unfilled, float("inf"))
        sc = 1.0 / math.sqrt(d_)
        got = decode_attention(q, k, v, lens, scale=sc)
        assert bool(torch.isfinite(got).all()), lab
        _check("decode_attention", got,
               reference_decode_attention(q, k, v, lens, scale=sc),
               str(dt).split(".")[1],
               f"H={h_} KV={kv_} T={T_} hd={d_} {lab} {dt}")
    # the real path reads one layer's cache after another: 18 distinct
    # caches exceed the 50 MB L2
    caches = [(randn(MAX_SLOTS, KV, MAX_LEN, hd, dtype=torch.bfloat16),
               randn(MAX_SLOTS, KV, MAX_LEN, hd, dtype=torch.bfloat16))
              for _ in range(cfg.n_groups)]
    q = randn(MAX_SLOTS, H, hd, dtype=torch.bfloat16)
    k, v = caches[0]
    # the same inputs give the same bits; the tickets reset after a call
    # with other lengths, so the next call is right again
    first = decode_attention(q, k, v, lengths_main, scale=scale)
    _check("decode_attention", first,
           reference_decode_attention(q, k, v, lengths_main, scale=scale),
           "bfloat16", "the timed inputs, main lengths bf16")
    assert torch.equal(first, decode_attention(q, k, v, lengths_main,
                                               scale=scale)), "not bitwise"
    decode_attention(q, k, v, edge, scale=scale)
    assert torch.equal(first, decode_attention(q, k, v, lengths_main,
                                               scale=scale)), "tickets"
    print("  check decode_attention  two calls bit-identical; right after a "
          "call with other lengths ok")
    # where a call spends its time, phase by phase (a -DDEC_TIMELINE build)
    tl = decode_timeline.run(lengths_main.tolist())
    print(f"  time  decode_attention  timeline (us at {tl['sm_clock_mhz']} "
          f"MHz): first start to last exit "
          f"{tl['first_start_to_last_exit_us']}; merging block "
          f"{tl['critical_block_us']}; partial blocks (median) "
          f"{tl['partial_blocks_median_us']}")
    valid = (torch.arange(MAX_LEN, device=dev)[None, :]
             < lengths_main[:, None])[:, None, None, :]
    filled = int(lengths_main.sum())
    nbytes = 2 * filled * KV * hd * 2 + 2 * q.numel() * 2 + MAX_SLOTS * 4
    b_ms, b_by = _bound_ms(nbytes, 4 * filled * H * hd, torch.bfloat16)
    rec["decode_attention"] = dict(
        shape=(f"q [{MAX_SLOTS},{H},{hd}] k,v [{MAX_SLOTS},{KV},{MAX_LEN},"
               f"{hd}] bf16, lengths {lengths_main.tolist()}"),
        max_abs_err=errs[(torch.bfloat16, H, KV, "main")],
        ms=_time_ms([lambda k=k, v=v: decode_attention(
            q, k, v, lengths_main, scale=scale) for k, v in caches]),
        launch_ms=_time_ms([lambda k=k, v=v: decode_attention(
            q, k, v, lengths_main, scale=scale) for k, v in caches],
            queued=False),
        plain_ms=_time_ms([lambda k=k, v=v: reference_decode_attention(
            q, k, v, lengths_main, scale=scale) for k, v in caches]),
        library_ms=_time_ms([lambda k=k, v=v: F.scaled_dot_product_attention(
            q[:, :, None], k, v, attn_mask=valid, scale=scale,
            enable_gqa=True) for k, v in caches]),
        bound_ms=b_ms, bound_by=b_by)

    # ---- flash attention: causal prefill, MQA and GQA, ragged S, S < T,
    # and head dims the wrapper pads (16, 32 -> 64 and 112 -> 128 in bf16;
    # 16 -> 32 in f32), the scale from the true head dim ---------------------
    for dt in (torch.float32, torch.bfloat16):
        for h_, kv_, S, T, d_ in ((H, KV, S_main, S_main, hd),
                                  (8, 2, 700, 700, hd), (H, KV, 300, 1023, hd),
                                  (H, KV, 200, 200, 16), (H, KV, 200, 200, 32),
                                  (8, 2, 300, 300, 112)):
            q = randn(1, h_, S, d_, dtype=dt)
            k = randn(1, kv_, T, d_, dtype=dt)
            v = randn(1, kv_, T, d_, dtype=dt)
            sc = 1.0 / math.sqrt(d_)
            errs[(dt, h_, kv_, S, T, d_)] = _check(
                "flash_attention", flash_attention(q, k, v, scale=sc),
                reference_attention(q, k, v, scale=sc),
                str(dt).split(".")[1],
                f"H={h_} KV={kv_} S={S} T={T} hd={d_} {dt}")
        # the prefill's own layout at each of its buckets: q a transposed
        # [B,S,H,hd] projection, k and v the first S rows of a max_len cache
        kc = randn(1, KV, MAX_LEN, hd, dtype=dt)
        vc = randn(1, KV, MAX_LEN, hd, dtype=dt)
        for S in buckets:
            q = randn(1, S, H, hd, dtype=dt).transpose(1, 2)
            _check("flash_attention",
                   flash_attention(q, kc[:, :, :S], vc[:, :, :S],
                                   scale=scale),
                   reference_attention(q, kc[:, :, :S], vc[:, :, :S],
                                       scale=scale),
                   str(dt).split(".")[1], f"strided views S={S} {dt}")
    # checks and times at every prefill bucket of phase 4's prompts
    for S in buckets:
        ins = [(randn(1, H, S, hd, dtype=torch.bfloat16),
                randn(1, KV, S, hd, dtype=torch.bfloat16),
                randn(1, KV, S, hd, dtype=torch.bfloat16))
               for _ in range(4)]
        err = _check("flash_attention", flash_attention(*ins[0], scale=scale),
                     reference_attention(*ins[0], scale=scale), "bfloat16",
                     f"bucket S={S} H={H} KV={KV} hd={hd} bf16")
        pairs = S * (S + 1) // 2
        nbytes = (2 * S * H * hd + 2 * S * KV * hd) * 2
        b_ms, b_by = _bound_ms(nbytes, 4 * pairs * H * hd, torch.bfloat16)
        r = dict(
            shape=f"q [1,{H},{S},{hd}] k,v [1,{KV},{S},{hd}] bf16",
            max_abs_err=err,
            ms=_time_ms([lambda t=t: flash_attention(*t, scale=scale)
                         for t in ins], iters=20),
            launch_ms=_time_ms([lambda t=t: flash_attention(*t, scale=scale)
                                for t in ins], iters=20, queued=False),
            plain_ms=_time_ms([lambda t=t: reference_attention(
                *t, scale=scale) for t in ins], iters=10),
            library_ms=_time_ms([lambda t=t: F.scaled_dot_product_attention(
                *t, is_causal=True, scale=scale, enable_gqa=True)
                for t in ins], iters=20),
            bound_ms=b_ms, bound_by=b_by)
        if S == S_main:
            rec["flash_attention"] = r
        else:
            print(f"  time  flash_attention   {r['shape']}: kernel_ms="
                  f"{r['ms']:.4f} (with host launch {r['launch_ms']:.4f}) "
                  f"plain_ms={r['plain_ms']:.4f} library_ms="
                  f"{r['library_ms']:.4f} bound_ms={r['bound_ms']:.5f} "
                  f"({r['bound_by']})")
    for name, r in rec.items():
        print(f"  time  {name:17s} {r['shape']}: kernel_ms={r['ms']:.4f} "
              f"(with host launch {r['launch_ms']:.4f}) plain_ms="
              f"{r['plain_ms']:.4f} library_ms={r['library_ms']:.4f} "
              f"bound_ms={r['bound_ms']:.5f} ({r['bound_by']})")
    return rec


# ---------------------------------------------------------------- phase 4
def phase_serving(cfg, prompts):
    """Full-width gemma-2b serving through the kernels and the tiers."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.core import units
    from repro_torch.core.policy import Tier, TieringPolicy
    from repro_torch.models import model as M
    from repro_torch.runtime import TieredStore, TierSpec, VirtualClock
    from repro_torch.serving import DecodeEngine, Request

    t0 = time.perf_counter()
    params = M.init_params(cfg, SEED, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in
                   _tensors(params))
    assert n_params == cfg.param_count() == 2_506_172_416, n_params
    print(f"  gemma-2b: {n_params} parameters, bf16, native init in "
          f"{time.perf_counter() - t0:.1f} s")

    # a paused session's blob: every K/V leaf of one slot, as float32
    attn = cfg.pattern[0][0]
    blob_bytes = 2 * cfg.n_groups * attn.n_kv * MAX_LEN * attn.head_dim * 4
    # the modeled hierarchy: the card's HBM (data-sheet size and rate),
    # host DRAM that holds 1.5 blobs, a Storage-Next SSD
    specs = {Tier.HBM: TierSpec(80e9, units.H100_HBM_BW, 1e-7),
             Tier.DRAM: TierSpec(1.5 * blob_bytes, 45e9, 5e-7),
             Tier.FLASH: TierSpec(4e12, 7e9, 2e-5)}
    clock = VirtualClock()
    policy = TieringPolicy(tau_hot=0.05, tau_be=1.0, ema_alpha=1.0)
    store = TieredStore(policy, specs=specs, clock=clock)
    eng = DecodeEngine(cfg, params, max_slots=MAX_SLOTS, max_len=MAX_LEN,
                       policy=policy, store=store, step_time=STEP_TIME,
                       compute_dtype=torch.bfloat16, device="cuda")

    # first-step logits: kernels vs the plain path, same bf16 weights.
    # Two bf16 computations of an 18-layer stack differ by the rounding
    # noise of each, so the tolerance is bf16's own error here: twice the
    # plain bf16 path's distance from the same path in float32.
    p0 = torch.as_tensor(prompts[0][None].astype(np.int64), device="cuda")

    def first_logits(weights, dtype, plain):
        cache = M.init_cache(cfg, 1, MAX_LEN, dtype, "cuda")
        return M.prefill(weights, cfg, p0, cache, compute_dtype=dtype,
                         plain=plain)[1].float()

    kernels.reset_launch_counts()
    kern = first_logits(params, torch.bfloat16, False)
    per_prefill = kernels.launch_counts()
    kernels.reset_launch_counts()
    M.decode_step(params, cfg, p0[:, :1], M.init_cache(
        cfg, 1, MAX_LEN, torch.bfloat16, "cuda"), 0,
        compute_dtype=torch.bfloat16)
    per_step = kernels.launch_counts()
    print(f"  launches per prefill {per_prefill}, per decode step "
          f"{per_step}")
    assert per_prefill["rmsnorm"] == per_step["rmsnorm"] == _norms(cfg), \
        (per_prefill, per_step)
    plain = first_logits(params, torch.bfloat16, True)
    params32 = _map(params, lambda t: t.float())
    truth = first_logits(params32, torch.float32, True)
    del params32
    err = float((kern - plain).abs().max())
    noise = float((plain - truth).abs().max())
    print(f"  first-step logits [1,{cfg.vocab}]: kernels vs plain bf16 "
          f"max_abs_err={err:.4e}; plain bf16 vs float32 {noise:.4e}; "
          f"kernels vs float32 {float((kern - truth).abs().max()):.4e}; "
          f"argmax {int(kern.argmax())} / {int(plain.argmax())} / "
          f"{int(truth.argmax())}")
    assert err <= 2 * noise, (err, noise)
    del kern, plain, truth
    torch.cuda.empty_cache()

    reqs = [Request(rid=f"s{i}", prompt=p, max_new=MAX_NEW)
            for i, p in enumerate(prompts[:N_REQUESTS])]
    extra = [Request(rid=f"s{i}", prompt=p, max_new=MAX_NEW)
             for i, p in enumerate(prompts[N_REQUESTS:N_REQUESTS + 2],
                                   start=N_REQUESTS)]
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    toks = sum(len(r.generated) for r in done)
    assert len(done) == N_REQUESTS and all(
        len(r.generated) == MAX_NEW for r in done), "requests unfinished"
    print(f"  served {len(done)} requests (prompts "
          f"{[len(r.prompt) for r in reqs]}), {toks} tokens in "
          f"{wall:.3f} s = {toks / wall:.1f} tokens/s, {eng.steps} "
          f"decode steps")

    # park two sessions; DRAM holds 1.5 blobs, so the colder goes to flash
    a, b = extra
    eng.admit(a)
    eng.admit(b)
    for _ in range(3):
        eng.step()
    tier_a = eng.pause(a.rid)
    tier_b = eng.pause(b.rid)
    tier_a_now = store.tier_of(("kv", a.rid))
    print(f"  paused {a.rid} -> {tier_a.name}, {b.rid} -> {tier_b.name}; "
          f"{a.rid} now on {tier_a_now.name}")
    assert tier_a_now == Tier.FLASH, "the colder session was not demoted"
    clock.advance(1.2)
    lead = eng.prefetch_lead(a.rid)
    eng.prefetch(a.rid)
    clock.advance(3 * STEP_TIME)
    eng.resume(a.rid)
    eng.resume(b.rid)
    while eng.live.any():
        eng.step()
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    flash_st = store.stats[Tier.FLASH]
    # the prefetch-led restore read the blob back from flash
    assert flash_st.demotions >= 1 and flash_st.hits >= 1 \
        and flash_st.prefetch_hits + flash_st.prefetch_late >= 1, flash_st
    assert all(len(r.generated) == MAX_NEW for r in extra)
    peak = torch.cuda.max_memory_allocated()
    print(f"  resumed {a.rid} from FLASH through a prefetch issued 3 steps "
          f"ahead (the p99-sized lead is {lead} steps): "
          f"kv_stall_time={eng.kv_stall_time!r} s; FLASH {flash_st}")
    print(f"  decode steps {eng.steps}; launches {counts}; peak device "
          f"memory {peak / 1e9:.3f} GB")
    counts = {name: counts[name] for name in SERVING_KERNELS}
    for name, n in counts.items():
        assert n > 0, f"{name} kernel never launched on the main path"
    _profile_split(eng, prompts)
    return counts


def _norms(cfg) -> int:
    """rmsnorm launches a forward: one before each sublayer and the final
    norm (the residual adds run inside them)."""
    return cfg.n_groups * sum(len(layer) for layer in cfg.pattern) + 1


def _profile_split(eng, prompts):
    """Where a prefill and a decode step spend the card's time: each under
    torch.profiler after a warm-up, with the device operations by time and
    the device-idle share, 1 - kernel time / wall. The profiler slows the
    host, so the share is given against the profiled wall and against the
    same work's wall without the profiler (host clock, synchronised)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving import Request

    def wall(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t

    # prompts 0, 2 and 5 fall in bucket 1023, prompt 1 in 256
    reqs = [Request(rid=f"prof{i}", prompt=prompts[i], max_new=MAX_NEW)
            for i in (0, 1, 2, 5)]
    eng.admit(reqs[0])                     # warm-up
    eng.admit(reqs[1])
    eng.step()
    plain_pre = wall(lambda: eng.admit(reqs[2]))
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof_pre:
        wall_pre = wall(lambda: eng.admit(reqs[3]))
    plain_step = sorted(wall(eng.step) for _ in range(5))[2]
    with profile(activities=acts) as prof_step:
        wall_step = wall(eng.step)
    for label, prof, w, w0 in (
            ("prefill, bucket 1023", prof_pre, wall_pre, plain_pre),
            (f"decode step, {MAX_SLOTS} live slots", prof_step, wall_step,
             plain_step)):
        kern = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        busy = sum(e.self_device_time_total for e in kern) / 1e3   # ms
        if busy == 0:
            print(f"  profile {label}: the profiler saw no device time; "
                  f"device split not measured")
            continue
        print(f"  profile {label}: device kernels {busy:.3f} ms; wall "
              f"{w * 1e3:.3f} ms profiled, {w0 * 1e3:.3f} ms without the "
              f"profiler; device-idle share {1 - busy / (w * 1e3):.3f} "
              f"profiled, {1 - busy / (w0 * 1e3):.3f} without")
        n_rms = sum(e.count for e in kern if "rmsnorm" in e.key)
        print(f"  profile {label}: {sum(e.count for e in kern)} device "
              f"operations, {n_rms} of them rmsnorm kernels")
        assert n_rms == _norms(eng.cfg), n_rms
        for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:8]:
            t = e.self_device_time_total / 1e3
            print(f"    {t:9.4f} ms {100 * t / busy:5.1f}% x{e.count:<4d} "
                  f"{e.key[:90]}")
        if label.startswith("decode"):
            dec = [e for e in kern if "decode_attention" in e.key]
            assert len(dec) == 1 and dec[0].count == eng.cfg.n_groups, \
                [(e.key, e.count) for e in dec]
            assert not any("merge" in e.key for e in kern), "merge kernel"
            t = dec[0].self_device_time_total / 1e3
            print(f"  decode step: one decode_attention kernel, "
                  f"{dec[0].count} launches, {t:.4f} ms = "
                  f"{100 * t / busy:.1f}% of device time")
    while eng.live.any():
        eng.step()


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    else:
        yield tree


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


# ---------------------------------------------------------------- phase 5
def phase_reduced(rng):
    """Reduced gemma-2b in float32: engine (kernels) vs plain greedy."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.serving import DecodeEngine, Request

    cfg = get_config("gemma-2b", reduced=True)
    params = M.init_params(cfg, SEED, device="cuda")
    prompts = [rng.integers(1, cfg.vocab, int(n)).astype(np.int32)
               for n in (5, 9, 17, 30)]
    eng = DecodeEngine(cfg, params, max_slots=2, max_len=64,
                       device="cuda")
    reqs = [Request(rid=f"r{i}", prompt=p, max_new=8)
            for i, p in enumerate(prompts)]
    eng.run(reqs)
    for req in reqs:
        cache = M.init_cache(cfg, 1, 64, torch.float32, "cuda")
        tok = torch.as_tensor(req.prompt[None].astype(np.int64),
                              device="cuda")
        cache, logits = M.prefill(params, cfg, tok, cache,
                                  compute_dtype=torch.float32, plain=True)
        out = [int(logits[0].argmax())]
        pos = len(req.prompt)
        while len(out) < req.max_new:
            cache, logits = M.decode_step(
                params, cfg, torch.tensor([[out[-1]]], device="cuda"),
                cache, pos, compute_dtype=torch.float32, plain=True)
            out.append(int(logits[0].argmax()))
            pos += 1
        assert req.generated == out, (req.rid, req.generated, out)
    print(f"  reduced gemma-2b f32: {len(reqs)} requests, kernel-path "
          f"greedy tokens == plain-path greedy tokens")


# ---------------------------------------------------------------- phase 6
def _fill_table(n_buckets, slots, keys, vals):
    """Fixture: place keys [n] (distinct, on the card) each into the first
    free slot of its bucket h1, else of h2, in key order, vectorised by
    bucket; keys that find neither full bucket free stay out. Returns
    (bucket_keys, bucket_vals [n_buckets, slots] int32, placed [n] bool)."""
    import torch
    from repro_torch.kernels.cuckoo_probe import hash_pair

    dev = keys.device
    tk = torch.zeros(n_buckets * slots, dtype=torch.int32, device=dev)
    tv = torch.zeros_like(tk)
    fill = torch.zeros(n_buckets, dtype=torch.int64, device=dev)
    placed = torch.zeros(len(keys), dtype=torch.bool, device=dev)
    for b in hash_pair(keys, n_buckets):
        idx = (~placed).nonzero().squeeze(1)
        bb, order = torch.sort(b[idx].long(), stable=True)
        idx = idx[order]
        rank = torch.arange(len(bb), device=dev) - torch.searchsorted(bb, bb)
        slot = fill[bb] + rank
        ok = slot < slots
        at = bb[ok] * slots + slot[ok]
        tk[at] = keys[idx[ok]]
        tv[at] = vals[idx[ok]]
        placed[idx[ok]] = True
        fill += torch.bincount(bb[ok], minlength=n_buckets)
    return tk.view(n_buckets, slots), tv.view(n_buckets, slots), placed


def _kv_demo():
    """examples/kvstore_demo.py's scenario on the card: returns (the timed
    store, its inner store, 4096 probe keys, all stored)."""
    import numpy as np
    from repro_torch.kvstore import TimedCuckooStore

    timed = TimedCuckooStore(KV_DEMO_BUCKETS, slots=KV_SLOTS,
                             dram_cache_items=1024, wal_limit=128,
                             device="cuda")
    store = timed.inner
    rng = np.random.default_rng(SEED)
    n = int(KV_DEMO_BUCKETS * KV_SLOTS * KV_LOAD)
    keys = rng.choice(np.arange(1, 10**8), size=n, replace=False)
    for k in keys:
        store.put(int(k), int(k) % 99991)
    store.flush()
    return timed, store, keys[rng.integers(0, n, 4096)].astype(np.int32)


def _kv_table(n_buckets, gen):
    """A table of n_buckets x KV_SLOTS on the card filled to ~KV_LOAD, and
    four sets of KV_PROBES probes, half stored and half absent. Returns
    (bucket_keys, bucket_vals [n_buckets, KV_SLOTS] contiguous, the stored
    keys, the probe sets)."""
    import torch
    dev = torch.device("cuda")
    n_fill = int(n_buckets * KV_SLOTS * KV_LOAD)
    half = KV_PROBES // 2
    pool = torch.unique(torch.randint(
        1, 2**31 - 1, (n_fill + max(n_fill // 8, 2 * half),), generator=gen,
        device=dev))
    pool = pool[torch.randperm(len(pool), generator=gen, device=dev)]
    assert len(pool) >= n_fill + half
    cand, absent = pool[:n_fill], pool[n_fill:n_fill + half]
    cand_vals = (cand * 2654435761 % 2**31).to(torch.int32)
    bk, bv, placed = _fill_table(n_buckets, KV_SLOTS, cand.to(torch.int32),
                                 cand_vals)
    stored = cand[placed]
    assert len(stored) >= half
    probes = []
    for _ in range(4):       # distinct probe sets for timing; set 0 checked
        sel = stored[torch.randperm(len(stored), generator=gen,
                                    device=dev)[:half]]
        p = torch.cat([sel, absent]).to(torch.int32)
        probes.append(p[torch.randperm(len(p), generator=gen, device=dev)])
    return bk, bv, stored, probes


def _probe_rows(bk, probes):
    """The rows the probes' lookups touch: both buckets' key rows, the
    value row of the bucket that hit, of each found key, the number of
    bucket rows the kernel reads (bucket 2 only after a miss in bucket
    1), and the number of distinct key rows the function needs (bucket
    1's of every lookup, bucket 2's of those that bucket 1 missed)."""
    import torch
    from repro_torch.kernels.cuckoo_probe import hash_pair
    out = []
    for p in probes:
        b1, b2 = hash_pair(p, bk.shape[0])
        in1 = (bk[b1.long()] == p[:, None]).any(1)
        in2 = (bk[b2.long()] == p[:, None]).any(1)
        out.append((torch.cat([b1, b2]).long(),
                    torch.where(in1, b1, b2)[in1 | in2].long(),
                    len(p) + int((~in1).sum()),
                    int(torch.unique(torch.cat([b1, b2[~in1]])).numel())))
    return out


def _probe_times(bk, bv, probes, label):
    """The kernel on the two layouts (one [n_buckets, 2 * slots] table, as
    the store keeps it, and two arrays) and, for the same random rows,
    torch.index_select of both buckets' key rows and of the hits' value
    rows: a gather, not the same function, and no library_ms."""
    import torch
    from repro_torch.kernels.cuckoo_probe import cuckoo_probe
    t = torch.cat([bk, bv], 1)
    joint = (t[:, :KV_SLOTS], t[:, KV_SLOTS:])
    rows = _probe_rows(bk, probes)
    ms = {
        "one row a bucket": _time_ms(
            [lambda p=p: cuckoo_probe(p, *joint) for p in probes]),
        "two arrays": _time_ms(
            [lambda p=p: cuckoo_probe(p, bk, bv) for p in probes]),
        "index_select key rows": _time_ms(
            [lambda r=r: torch.index_select(bk, 0, r[0]) for r in rows]),
        "index_select value rows": _time_ms(
            [lambda r=r: torch.index_select(bv, 0, r[1]) for r in rows])}
    n_rows, n_hits = len(rows[0][0]), len(rows[0][1])
    reads = sum(r[2] for r in rows) / len(rows)
    print(f"  time  cuckoo_probe {label}: kernel, one row a bucket "
          f"{ms['one row a bucket']:.6f} ms, two arrays "
          f"{ms['two arrays']:.6f} ms; it reads "
          f"{reads / len(probes[0]):.4f} bucket rows a lookup, "
          f"{reads / ms['one row a bucket'] / 1e6:.2f} G rows/s; "
          f"index_select of {n_rows} key rows "
          f"({n_rows * KV_SLOTS * 4 / 2**20:.0f} MiB written) "
          f"{ms['index_select key rows']:.6f} ms, of {n_hits} value rows "
          f"({n_hits * KV_SLOTS * 4 / 2**20:.0f} MiB written) "
          f"{ms['index_select value rows']:.6f} ms")
    return ms


def _probe_edges():
    """The kernel bit for bit (torch.equal) against its plain version on
    every path: slots 4, 8 and 16 (vector) and 5 (scalar); two arrays,
    one table of both (the store's) and that table at a 4-byte offset
    (scalar); N = 0, 1, 255-257, one group and +-1, 4096; n_buckets = 1
    (h1 == h2); negative keys and values; the tests' hand-made table (a
    key in both buckets, a duplicate hit, key 0, the int32 wrap); the
    launch plan the card takes against ops.launch_plan. Returns the
    number of cases."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.cuckoo_probe import (cuckoo_probe, hash_pair,
                                                  ops as probe_ops,
                                                  reference_cuckoo_probe)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count

    def layouts(tk, tv):
        nb, s = tk.shape
        t = torch.cat([tk, tv], 1)
        flat = torch.empty(t.numel() + 1, dtype=torch.int32, device=dev)
        off = flat[1:].view(nb, 2 * s)
        off.copy_(t)
        return {"two arrays": (tk, tv), "one table": (t[:, :s], t[:, s:]),
                "4-byte offset": (off[:, :s], off[:, s:])}

    def aligned(*ts):
        return all(t.data_ptr() % 16 == 0 and t.stride(0) % 4 == 0
                   for t in ts)

    n_cases = 0

    def case(label, keys, bk, bv):
        nonlocal n_cases
        f, v = cuckoo_probe(keys, bk, bv)
        rf, rv = reference_cuckoo_probe(keys, *hash_pair(keys, bk.shape[0]),
                                        bk, bv)
        assert torch.equal(f, rf) and torch.equal(v, rv), \
            f"cuckoo_probe {label}: kernel != plain"
        n_cases += 1
        return f, v

    def rand_i32(n):
        return torch.randint(-2**31, 2**31 - 1, (n,), generator=gen,
                             device=dev, dtype=torch.int64).to(torch.int32)

    paths = set()
    for slots in (4, 5, 8, 16):
        nb = 4096
        pool = torch.unique(rand_i32(2 * nb * slots))
        pool = pool[pool != 0]
        pool = pool[torch.randperm(len(pool), generator=gen, device=dev)]
        n_fill = int(nb * slots * KV_LOAD)
        tk, tv, placed = _fill_table(nb, slots, pool[:n_fill],
                                     rand_i32(n_fill))
        stored = pool[:n_fill][placed]
        probe = torch.cat([stored[:2048], pool[n_fill:n_fill + 2047],
                           torch.zeros(1, dtype=torch.int32, device=dev)])
        probe = probe[torch.randperm(len(probe), generator=gen, device=dev)]
        assert (probe < 0).any() and len(probe) == 4096
        for name, (bk, bv) in layouts(tk, tv).items():
            plan = probe_ops.launch_plan(len(probe), slots, n_sm,
                                         aligned(bk, bv))
            assert (plan["path"] == "scalar") == (
                slots == 5 or name == "4-byte offset"), (slots, name, plan)
            paths.add(plan["path"])
            g = plan["lookups"] * plan["threads"]
            for n in sorted({0, 1, 255, 256, 257, g - 1, g, g + 1, 4096}):
                case(f"slots {slots}, {name}, N {n}", probe[:n], bk, bv)
        # one bucket: h1 == h2 == 0
        row = torch.zeros(1, slots, dtype=torch.int32, device=dev)
        row[0, :3] = torch.tensor([7, -9, -9], device=dev)
        rowv = torch.zeros_like(row)
        rowv[0, :3] = torch.tensor([70, 2**31 - 1, 5], device=dev)
        one = torch.tensor([7, -9, 0, 8, -2**31], dtype=torch.int32,
                           device=dev)
        for name, (bk, bv) in layouts(row, rowv).items():
            f, v = case(f"slots {slots}, {name}, one bucket", one, bk, bv)
            assert f.tolist() == [1, 1, 1, 0, 0]
            assert v.tolist()[:3] == [70, -2**31 + 4, 0]
    assert paths == {"vector", "scalar"}

    # the tests' hand-made table (tests/test_torch_case_studies.py)
    nb, slots = 16, 4
    b1, b2 = (h.tolist() for h in hash_pair(
        torch.arange(1, 200, dtype=torch.int32, device=dev), nb))
    both = next(k for k in range(1, 200) if b1[k - 1] != b2[k - 1])
    dup = next(k for k in range(1, 200) if k != both
               and b1[k - 1] not in (b1[both - 1], b2[both - 1]))
    hk = torch.zeros(nb, slots, dtype=torch.int32, device=dev)
    hv = torch.zeros_like(hk)
    hk[b1[both - 1], 0], hv[b1[both - 1], 0] = both, 11
    hk[b2[both - 1], 1], hv[b2[both - 1], 1] = both, 22
    hk[b1[dup - 1], 2:4] = dup
    hv[b1[dup - 1], 2:4] = torch.tensor([5, 7], device=dev)
    hand = torch.tensor([both, dup, 0, 12345], dtype=torch.int32,
                        device=dev)
    for name, (bk, bv) in layouts(hk, hv).items():
        f, v = case(f"hand-made table, {name}", hand, bk, bv)
        assert f.tolist() == [1, 1, 1, 0] and v.tolist() == [11, 12, 0, 0]
    hv[b1[dup - 1], 2:4] = torch.tensor([2**31 - 1, 2**31 - 2], device=dev)
    for name, (bk, bv) in layouts(hk, hv).items():
        f, v = case(f"int32 wrap, {name}", hand[1:2], bk, bv)
        assert v.tolist() == [-3]

    # the plan the card takes == the Python twin; the grid's blocks fit
    plan_of = _build.library("cuckoo_probe_plan_of")
    got = (ctypes.c_longlong * 5)()
    for slots in (4, 5, 8, 16):
        for al in (True, False):
            g = probe_ops.launch_plan(1, slots, n_sm, al)
            g = g["lookups"] * g["threads"]
            for n in (0, 1, g - 1, g, g + 1, 4096, KV_PROBES, 2**31):
                want = probe_ops.launch_plan(n, slots, n_sm, al)
                _build.check("cuckoo_probe_plan_of",
                             plan_of(n, slots, int(al), got))
                card = {"threads": got[0], "lookups": got[1],
                        "blocks": got[2],
                        "path": "vector" if got[3] else "scalar"}
                assert card == want, (n, slots, al, card, want)
                assert got[4] >= probe_ops.BLOCKS_PER_SM, \
                    f"{got[4]} resident blocks an SM, the grid assumes " \
                    f"{probe_ops.BLOCKS_PER_SM}"
                n_cases += 1
    return n_cases


def phase_kvstore():
    """The cuckoo store through its entry points, then the probe kernel at
    deployment size against its plain version, on every path, and timed.
    Returns (launches, record)."""
    import torch
    from repro_torch import kernels
    from repro_torch.kernels.cuckoo_probe import (cuckoo_probe, hash_pair,
                                                  reference_cuckoo_probe)
    from repro_torch.kvstore import BlockedCuckooStore

    t0 = time.perf_counter()
    # (a) examples/kvstore_demo.py's scenario
    timed, store, probe = _kv_demo()
    kernels.reset_launch_counts()
    found, vals = store.get_batch(probe)
    launches = kernels.launch_counts()["cuckoo_probe"]
    assert found.all() and (vals == probe % 99991).all(), "demo GETs wrong"
    pf, pv = store.get_batch(probe, use_kernel=False)
    assert (pf == found).all() and (pv == vals).all()
    print(f"  demo store: {len(store.keys.nonzero()[0])} items at load "
          f"{store.load_factor():.4f}, {store.stats.relocations} "
          f"relocations; batched GET x{len(probe)} through the kernel: all "
          f"found, all values right, == plain version; {store.stats}")
    got = timed.get_many(probe[:100].tolist())
    assert got == [int(k) % 99991 for k in probe[:100]]
    print(f"  timed store get_many x100: modeled {timed.clock.now()!r} s\n"
          + "\n".join("    " + line
                      for line in timed.modeled_report().splitlines()))

    # (b) 2^23 buckets x 8 slots on the card, filled to ~0.7
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    bk, bv, stored, probes = _kv_table(KV_BUCKETS, gen)
    half = KV_PROBES // 2
    big = BlockedCuckooStore.from_table(bk.cpu().numpy(), bv.cpu().numpy(),
                                        device="cuda")
    bk_d, bv_d = big.device_table()
    assert bk_d.data_ptr() + KV_SLOTS * 4 == bv_d.data_ptr() \
        and bk_d.stride() == bv_d.stride() == (2 * KV_SLOTS, 1), \
        "the store's table is not one row a bucket"
    print(f"  deployment table: {KV_BUCKETS} buckets x {KV_SLOTS} slots "
          f"({bk_d.numel() * 8 / 2**20:.0f} MiB on the card, keys and "
          f"values of a bucket in one row), {len(stored)} keys placed of "
          f"{int(KV_BUCKETS * KV_SLOTS * KV_LOAD)} (load "
          f"{big.load_factor():.4f})")
    kernels.reset_launch_counts()
    f, v = big.get_batch(probes[0])
    torch.cuda.synchronize()
    launches += kernels.launch_counts()["cuckoo_probe"]
    # the check: kernel == plain version exactly; stored found, absent not
    rf, rv = reference_cuckoo_probe(
        probes[0], *hash_pair(probes[0], KV_BUCKETS), bk_d, bv_d)
    assert torch.equal(f, rf) and torch.equal(v, rv), "kernel != plain"
    f2, v2 = cuckoo_probe(probes[0], bk, bv)
    assert torch.equal(f2, f) and torch.equal(v2, v), "two arrays != table"
    want_v = torch.zeros_like(v)
    is_stored = torch.isin(probes[0], stored.to(torch.int32))
    assert int(is_stored.sum()) == half
    assert torch.equal(f.bool(), is_stored), "a stored key was missed or " \
        "an absent one found"
    want_v[is_stored] = (probes[0][is_stored].long() * 2654435761
                         % 2**31).to(torch.int32)
    assert torch.equal(v, want_v), "wrong values"
    print(f"  check cuckoo_probe      {KV_PROBES} probes (half stored) "
          f"max_abs_err=0 (exact, store's table and two arrays) ok: "
          f"{int(f.sum())} found")
    n_edges = _probe_edges()
    print(f"  check cuckoo_probe      {n_edges} edge cases and launch plans "
          f"(slots 4/5/8/16, two arrays, one table, a 4-byte offset, N "
          f"0..4096, one bucket, the hand-made table, int32 wrap) exact ok")
    # bytes the lookups need: each probed key, each key row once (bucket
    # 2's only where bucket 1 missed: a hit there decides both outputs),
    # the hit value, and found + value out
    rows = _probe_rows(bk, probes[:1])[0][3]
    nbytes = KV_PROBES * 4 + rows * KV_SLOTS * 4 + half * 4 + KV_PROBES * 8
    b_ms, b_by = _bound_ms(nbytes, 0, torch.int32)
    print(f"  bound cuckoo_probe      {rows} distinct key rows needed, "
          f"{nbytes} bytes")
    pk = torch.as_tensor(probe, device="cuda")
    dk, dv = store.device_table()
    demo = [lambda: cuckoo_probe(pk, dk, dv)]
    demo_ms = _time_ms(demo)
    demo_launch_ms = _time_ms(demo, queued=False)
    _probe_times(bk, bv, probes,
                 f"{KV_PROBES} GETs into [{KV_BUCKETS},{KV_SLOTS}]")
    sk, sv, _, sp = _kv_table(KV_L2_BUCKETS, gen)
    _probe_times(sk, sv, sp,
                 f"{KV_PROBES} GETs into [{KV_L2_BUCKETS},{KV_SLOTS}] "
                 f"({2 * sk.numel() * 4 / 2**20:.0f} MiB, inside L2)")
    print(f"  time  cuckoo_probe demo batch x{len(probe)}: device "
          f"{demo_ms:.6f} ms, with the host's launch {demo_launch_ms:.6f} ms")
    calls = [lambda p=p: cuckoo_probe(p, bk_d, bv_d) for p in probes]
    rec = dict(
        shape=(f"keys [{KV_PROBES}] (half stored), table [{KV_BUCKETS},"
               f"{2 * KV_SLOTS}] int32 (keys | values a row)"),
        max_abs_err=0.0, ms=_time_ms(calls),
        launch_ms=_time_ms(calls, queued=False),
        plain_ms=_time_ms([lambda p=p: reference_cuckoo_probe(
            p, *hash_pair(p, KV_BUCKETS), bk_d, bv_d) for p in probes],
            iters=8),
        library_ms=None, library="none: no PyTorch call probes a cuckoo "
        "table", bound_ms=b_ms, bound_by=b_by)
    print(f"  phase 6 wall {time.perf_counter() - t0:.1f} s")
    return launches, rec


# ---------------------------------------------------------------- phase 7
def _separated_id_mismatches(d_ref_k1, ids, ids_ref, copies=None):
    """ids equal wherever the plain version's neighbouring distances (its
    k+1 nearest, so the k-th has a next) differ by more than ANN_TIE.
    `copies` [Q, k+1] marks the places that hold a copy of the row
    before them: a run of copies has one distance on both sides and is
    ordered by id, so it counts as one place, set apart by the gaps
    before and after the run."""
    import torch
    inf = torch.full_like(d_ref_k1[:, :1], math.inf)
    before = torch.cat([inf, d_ref_k1[:, 1:] - d_ref_k1[:, :-1]], dim=1)
    first = torch.ones_like(before, dtype=torch.bool) if copies is None \
        else ~copies
    first[:, 0] = True
    run = torch.cumsum(first.long(), dim=1) - 1
    # the gap before each run; after run r comes run r + 1's
    gap = torch.cat([inf.expand_as(before), inf], dim=1).scatter_reduce(
        1, run, torch.where(first, before, inf.expand_as(before)), "amin")
    sep = (gap.gather(1, run) > ANN_TIE) & (gap.gather(1, run + 1) > ANN_TIE)
    sep = sep[:, :ids.shape[1]]
    return int(((ids != ids_ref) & sep).sum()), int(sep.sum())


def _ann_case(q_, c_, k_, lab, group=None, rank=None):
    """ann_topk against its plain version on the card: distances within
    ANN_ATOL, distinct ids, equal to the plain version's at every
    separated place; for a corpus of copied rows (`group`: each row's
    pool row, `rank`: its place among the copies by id) every tied group
    resolved to its lowest ids. Returns max_abs_err."""
    import torch
    from repro_torch.kernels.ann_topk import ann_topk, reference_ann_topk
    n = c_.shape[0]
    d, ids = ann_topk(q_, c_, k=k_)
    rd, rids = reference_ann_topk(q_, c_, min(k_ + 1, n))
    if k_ == n:                    # no next: the k-th is set apart from it
        rd = torch.cat([rd, torch.full_like(rd[:, :1], math.inf)], dim=1)
    copies = None
    if group is not None:
        g = group[rids.long()]
        copies = torch.zeros_like(g, dtype=torch.bool)
        copies[:, 1:] = g[:, 1:] == g[:, :-1]
        if k_ == n:
            copies = torch.cat([copies, torch.zeros_like(copies[:, :1])], 1)
    rids = rids[:, :k_]
    err = float((d - rd[:, :k_]).abs().max())
    bad, n_sep = _separated_id_mismatches(rd, ids, rids, copies)
    assert d.shape == ids.shape == (q_.shape[0], k_), (lab, d.shape)
    assert bool(torch.isfinite(d).all()), lab
    assert bool((ids.sort(dim=1).values.diff(dim=1) > 0).all()), lab
    assert err <= ANN_ATOL and bad == 0, (lab, k_, err, bad)
    tied = ""
    if group is not None:
        g = group[ids.long()]
        held = (g[:, :, None] == g[:, None, :]).sum(dim=-1)
        not_lowest = int((rank[ids.long()] >= held).sum())
        assert not_lowest == 0, (lab, k_, not_lowest)
        tied = (f"; {int((held > 1).sum())} places in tied groups, each "
                f"group's lowest ids")
    print(f"  check ann_topk          {lab} k={k_} max_abs_err={err:.3e}; "
          f"ids equal at all {n_sep} separated places "
          f"({int((ids != rids).sum())} near-tie swaps){tied}; ok")
    return err


def _tied_corpus(gen_np, n, d, pool, n_q):
    """n rows copied from `pool` random rows (norm ~1) at scattered ids,
    so exact ties cross tile and split borders, and n_q queries near pool
    rows. Returns (queries, corpus, group, rank) on the card: each row's
    pool row and its place among that row's copies by id."""
    import numpy as np
    import torch
    rows = (gen_np.standard_normal((pool, d)) / math.sqrt(d)).astype(
        np.float32)
    group = gen_np.integers(0, pool, n)
    order = np.argsort(group, kind="stable")
    first = np.searchsorted(group[order], group[order], side="left")
    rank = np.empty(n, np.int64)
    rank[order] = np.arange(n) - first
    qs = rows[gen_np.integers(0, pool, n_q)] + (0.3 / math.sqrt(d)) * \
        gen_np.standard_normal((n_q, d)).astype(np.float32)
    return tuple(torch.from_numpy(a).cuda() for a in
                 (qs, rows[group], group, rank))


def _ann_pass_split(fn):
    """Device ms a call of each kernel that `fn` launches, by
    torch.profiler over three calls (each kernel's time over the calls the
    profiler recorded of it); {} when it sees no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
    return {e.key.split("(")[0].replace("void ", ""):
            e.self_device_time_total / e.count / 1e3
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total}


def phase_ann():
    """Two-stage search over the full corpus on the card, ann_topk held
    against its plain version and timed. Returns (launches, record)."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.ann.corpus import make_corpus, make_queries
    from repro_torch.ann.progressive import exact_topk, recall_at_k, search
    from repro_torch.kernels.ann_topk import ann_topk, reference_ann_topk
    from repro_torch.kernels.ann_topk import timeline as ann_timeline
    from repro_torch.kernels.ann_topk.ops import (blocks_per_sm,
                                                  resident_blocks, smem_bytes)

    t0 = time.perf_counter()
    full_np, red_np, _ = make_corpus(ANN_N, ANN_D_FULL, ANN_D_RED,
                                     seed=SEED)
    qs_np = make_queries(full_np, ANN_Q)
    full = torch.from_numpy(full_np).cuda()
    red = torch.from_numpy(red_np).cuda()
    qs = torch.from_numpy(qs_np).cuda()
    del full_np
    small_full, small_red, _ = make_corpus(ANN_SMALL[0], ANN_D_FULL,
                                           ANN_D_RED)
    small_q = make_queries(small_full, ANN_SMALL[1])
    print(f"  corpus {ANN_N} x {ANN_D_FULL} f32 ({full.numel() * 4 / 2**30:.2f}"
          f" GiB) + reduced {ANN_D_RED}-d, {ANN_Q} queries, made in "
          f"{time.perf_counter() - t0:.1f} s")

    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    pred, stats = search(qs, red, full, k=ANN_K, promote=ANN_PROMOTE,
                         device="cuda")
    torch.cuda.synchronize()
    t_search = time.perf_counter() - t1
    small_pred, _ = search(small_q, small_red, small_full, k=ANN_K,
                           promote=ANN_PROMOTE, device="cuda")
    launches = kernels.launch_counts()["ann_topk"]

    truth = exact_topk(qs, full, ANN_K, device="cuda")
    rec = recall_at_k(pred, truth)
    small_rec = recall_at_k(small_pred, exact_topk(
        small_q, small_full, ANN_K, device="cuda"))
    print(f"  search {ANN_Q} queries over {ANN_N}: recall@{ANN_K} = {rec!r} "
          f"against exact search on the card; {t_search * 1e3:.1f} ms wall; "
          f"{stats}")
    print(f"  search at the reference tests' size ({ANN_SMALL[0]} vectors, "
          f"{ANN_SMALL[1]} queries): recall@{ANN_K} = {small_rec!r}")
    assert pred.shape == (ANN_Q, ANN_K) and small_rec > 0.98, small_rec
    assert int(pred.min()) >= 0 and int(pred.max()) < ANN_N
    assert bool((pred.sort(dim=1).values.diff(dim=1) > 0).all())

    # the resident first-pass blocks the card reports at each k: the
    # shared-memory rule that the CPU test of split_plan takes
    rule = resident_blocks()
    per_sm = {k_: blocks_per_sm(k_, red.device)
              for k_ in (1, 64, 88, 89, 128, 256)}
    print(f"  ann_topk resident blocks an SM by k: {per_sm}; the rule "
          f"({smem_bytes()} B of shared memory a block): {rule}")
    assert all(n == rule for n in per_sm.values()), (per_sm, rule)

    # ann_topk against its plain version at the path's shapes and at the
    # deeper promotes of (c); then at edges of the design
    q_red = qs[:, :ANN_D_RED].contiguous()
    small = (torch.from_numpy(small_q[:, :ANN_D_RED]).cuda(),
             torch.from_numpy(small_red).cuda())
    path = f"[{ANN_Q},{ANN_D_RED}] x [{ANN_N},{ANN_D_RED}]"
    errs = {}
    for q_, c_, k_, lab in (
            (q_red, red, ANN_PROMOTE, path),
            (*small, ANN_PROMOTE, f"[{ANN_SMALL[1]},{ANN_D_RED}] x "
             f"[{ANN_SMALL[0]},{ANN_D_RED}]"),
            *((q_red, red, k_, path) for k_ in ANN_DEEP)):
        errs.setdefault(k_, _ann_case(q_, c_, k_, lab))
    gen = np.random.default_rng(SEED)
    tq, tc, group, rank = _tied_corpus(gen, ANN_TIED[0], ANN_D_RED,
                                       ANN_TIED[1], ANN_TIED[2])
    for k_ in (ANN_PROMOTE, 256):
        _ann_case(tq, tc, k_, f"[{ANN_TIED[2]},{ANN_D_RED}] x "
                  f"[{ANN_TIED[0]},{ANN_D_RED}] copies of {ANN_TIED[1]} rows",
                  group, rank)

    def randn(*shape):             # rows of norm ~1, as the path's
        return torch.from_numpy((gen.standard_normal(shape) / math.sqrt(
            shape[1])).astype(np.float32)).cuda()
    for n_ in (300, 256):
        _ann_case(randn(100, ANN_D_RED), randn(n_, ANN_D_RED), 256,
                  f"[100,{ANN_D_RED}] x [{n_},{ANN_D_RED}]")
    for n_q in (1, 65):
        for k_ in (ANN_PROMOTE, 256):
            _ann_case(q_red[:n_q].contiguous(), red, k_,
                      f"[{n_q},{ANN_D_RED}] x [{ANN_N},{ANN_D_RED}]")
    _ann_case(randn(100, 30), randn(5000, 30), ANN_PROMOTE,
              "[100,30] x [5000,30] (rows not 16-byte aligned)")
    for k_ in (ANN_PROMOTE, 256):
        _ann_case(qs[:100].contiguous(), full[:20000], k_,
                  f"[100,{ANN_D_FULL}] x [20000,{ANN_D_FULL}]")
    for k_ in (ANN_PROMOTE, 256):
        d1, i1 = ann_topk(q_red, red, k=k_)
        d2, i2 = ann_topk(q_red, red, k=k_)
        assert torch.equal(d1.view(torch.int32), d2.view(torch.int32)) \
            and torch.equal(i1, i2), k_
        print(f"  check ann_topk          {path} k={k_}: two calls "
              f"bit-identical")

    cn = torch.sum(red * red, dim=1)
    flops = 2 * ANN_Q * ANN_N * ANN_D_RED
    # where stage 1's time goes: the kernel at k = 1 (products, almost no
    # selection), at the promotes, a bare float32 GEMM of the same shape
    # and the PyTorch calls that give the same result
    gemm_ms = _time_ms([lambda: torch.addmm(cn[None, :], q_red, red.T,
                                            alpha=-2.0)], iters=10)
    times = {}
    for k_ in (1, ANN_PROMOTE, *ANN_DEEP):
        b_ms, b_by = _bound_ms((q_red.numel() + red.numel()) * 4
                               + ANN_Q * k_ * 8, flops, torch.float32)
        times[k_] = dict(
            ms=_time_ms([lambda: ann_topk(q_red, red, k=k_)], iters=10),
            launch_ms=_time_ms([lambda: ann_topk(q_red, red, k=k_)],
                               iters=10, queued=False),
            plain_ms=_time_ms([lambda: reference_ann_topk(q_red, red, k_)],
                              iters=5),
            library_ms=_time_ms([lambda: torch.topk(torch.addmm(
                cn[None, :], q_red, red.T, alpha=-2.0), k_, largest=False)],
                iters=10),
            bound_ms=b_ms, bound_by=b_by)
        t = times[k_]
        print(f"  time  ann_topk          queries [{ANN_Q},{ANN_D_RED}] "
              f"corpus [{ANN_N},{ANN_D_RED}] f32, k={k_}: kernel_ms="
              f"{t['ms']!r} (with host launch {t['launch_ms']!r}) plain_ms="
              f"{t['plain_ms']!r} library_ms={t['library_ms']!r} "
              f"bound_ms={b_ms!r} ({b_by})")
    print("  time  ann_topk by k: " + "; ".join(
        f"k={k_} kernel {t['ms']:.4f} ms, addmm + topk "
        f"{t['library_ms']:.4f}" for k_, t in times.items())
        + f"; torch.addmm alone {gemm_ms:.4f} ms (float32, same shape)")
    for k_ in (ANN_PROMOTE, 256):
        split = _ann_pass_split(lambda: ann_topk(q_red, red, k=k_))
        total = sum(split.values())
        print(f"  profile ann_topk k={k_}: " + (", ".join(
            f"{name} {ms:.4f} ms ({ms / total:.1%})"
            for name, ms in split.items()) if split else
            "the profiler saw no device time; split not measured"))
    for k_ in (ANN_PROMOTE, *ANN_DEEP):
        assert times[k_]["ms"] < times[k_]["library_ms"], (k_, times[k_])
    # where a call's time goes, phase by phase (a -DANN_TIMELINE build)
    tl = ann_timeline.run(q_red, red, tuple(times))
    for k_, ph in tl["k"].items():
        print(f"  time  ann_topk          timeline k={k_} (us, median "
              f"block, SM clock {ph['sm_clock_mhz']} MHz): " + ", ".join(
                  f"{p}={ph[p]}" for p in ann_timeline.PHASES)
              + f"; a block's merge rounds {ph['n_rounds']}, merges "
              f"{ph['n_merges']}, candidates {ph['n_survivors']}; first "
              f"start to last exit {ph['first_start_to_last_exit_us']}")

    # (c) deeper promotes, and the recall they buy at 262,144 vectors;
    # at the deepest, the same search with stage 1 by exact_topk
    for k_ in ANN_DEEP:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        pred_k, _ = search(qs, red, full, k=ANN_K, promote=k_, device="cuda")
        torch.cuda.synchronize()
        rec_k = recall_at_k(pred_k, truth)
        print(f"  search promote {k_}: recall@{ANN_K} = {rec_k!r} over "
              f"{ANN_N} vectors; {(time.perf_counter() - t1) * 1e3:.1f} ms "
              f"wall")
        assert rec_k >= rec, (k_, rec_k, rec)
    pred_p, _ = search(qs, red, full, k=ANN_K, promote=ANN_DEEP[-1],
                       use_kernel=False, device="cuda")
    rec_p = recall_at_k(pred_p, truth)
    print(f"  search promote {ANN_DEEP[-1]}: recall@{ANN_K} = {rec_k!r} "
          f"(ann_topk), {rec_p!r} (use_kernel=False)")
    assert abs(rec_k - rec_p) <= 0.002, (rec_k, rec_p)

    t = times[ANN_PROMOTE]
    out = dict(
        shape=(f"queries [{ANN_Q},{ANN_D_RED}] corpus [{ANN_N},{ANN_D_RED}]"
               f" f32, k={ANN_PROMOTE}"),
        max_abs_err=errs[ANN_PROMOTE], ms=t["ms"], launch_ms=t["launch_ms"],
        plain_ms=t["plain_ms"], library_ms=t["library_ms"],
        library="torch.addmm(|c|^2, q, c.T, alpha=-2) + torch.topk "
        "(|c|^2 precomputed)",
        bound_ms=t["bound_ms"], bound_by=t["bound_by"])
    print(f"  phase 7 wall {time.perf_counter() - t0:.1f} s")
    return launches, out


# ---------------------------------------------------------------- phase 8
def _sketch_edges(tau0: float, n_buckets: int, ulps: int = 64):
    """float32 intervals at tau0 * 2^b for b in -2 .. B+1, and 1 .. `ulps`
    ulps either side of each: where a floor of log2 can go either way."""
    import numpy as np
    base = np.float32(tau0) * np.exp2(np.arange(-2, n_buckets + 2)).astype(
        np.float32)
    steps = np.arange(-ulps, ulps + 1, dtype=np.int64)
    bits = base.view(np.int32).astype(np.int64)[:, None] + steps[None, :]
    return bits.astype(np.int32).view(np.float32).ravel()


def _sketch_specials(n_classes: int):
    """Special intervals crossed with in- and out-of-range class ids."""
    import numpy as np
    f32 = np.finfo(np.float32)
    iv = np.array([0.0, -0.0, -1.0, -1e-9, np.nan, np.inf, -np.inf,
                   1e-45, 1e-40, float(f32.tiny), 1e-30, 1e-9, 1e38,
                   float(f32.max)], np.float32)
    cls = np.array([-1, 0, 1, n_classes - 1, n_classes], np.int32)
    return np.repeat(iv, len(cls)), np.tile(cls, len(iv))


def phase_autopilot():
    """The reuse-sketch kernel bit for bit against its plain version (one
    batch and M batches in one call, both paths), the admission benchmark
    on the card (byte-identical to the CPU run), and a control plane at the
    scale replay's size. Returns (launches, record)."""
    import hashlib

    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.autopilot import ReuseTracker
    from repro_torch.autopilot.bench import run_suite
    from repro_torch.kernels.reuse_sketch import (reference_reuse_sketch,
                                                  reuse_sketch_update)
    from repro_torch.kernels.reuse_sketch import ops as sketch_ops
    from repro_torch.obs import bench_json

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    limit = sketch_ops.SMALL_MAX_SLOTS

    def case(C, B, iv, cls, tau0, decay, ends=None):
        hist = (rng.random((C, B)) * 7).astype(np.float32)
        return [torch.from_numpy(np.ascontiguousarray(a)) for a in
                (hist, iv.astype(np.float32), cls.astype(np.int32))] + [
            dict(tau0=tau0, decay=decay),
            None if ends is None else torch.from_numpy(
                np.asarray(ends, np.int32))]

    def log_uniform(n, C):
        iv = np.power(10.0, rng.uniform(-9.0, 5.0, n)).astype(np.float32)
        return iv, rng.integers(-1, C + 1, n)

    def cuts(n, m, n_empty):
        """ends of m segments over n slots at random cuts, n_empty of the
        segments empty"""
        e = np.sort(rng.choice(np.arange(1, n), m - 1 - n_empty,
                               replace=False))
        e = np.sort(np.concatenate([e, rng.choice(e, n_empty)]))
        return np.append(e, n)

    C_BENCH, C_PLANE, B = 8, 4, 32
    cases = {
        "hist [8,32] N=1 (bench)": case(
            C_BENCH, B, np.array([0.75]), np.array([0]), 1e-3, 0.995),
        f"hist [4,32] N={SKETCH_N_STEP} log-uniform": case(
            C_PLANE, B, *log_uniform(SKETCH_N_STEP, C_PLANE), 1e-3, 0.995),
        "hist [4,32] N=2^20 log-uniform": case(
            C_PLANE, B, *log_uniform(1 << 20, C_PLANE), 1e-3, 0.995),
        "hist [4,32] N=0": case(
            C_PLANE, B, np.zeros(0), np.zeros(0), 1e-3, 0.995),
    }
    # 7e-3: a multiply by tau0's float32 reciprocal would move some edges
    for tau0 in (1e-3, 7e-3):
        edges = _sketch_edges(tau0, B)
        cases[f"hist [4,32] {edges.size} edges {tau0}*2^b +-64 ulps"] = \
            case(C_PLANE, B, edges, rng.integers(0, C_PLANE, edges.size),
                 tau0, 0.995)
    # past the kernel's exponent shortcut (the top 256 mantissas of a
    # binade take the log2) on both sides
    edges = _sketch_edges(1e-3, B, 1024)
    cases[f"hist [4,32] {edges.size} edges 0.001*2^b +-1024 ulps"] = case(
        C_PLANE, B, edges, rng.integers(0, C_PLANE, edges.size), 1e-3, 0.995)
    sp_iv, sp_cls = _sketch_specials(C_PLANE)
    cases[f"hist [4,32] {sp_iv.size} special values"] = case(
        C_PLANE, B, sp_iv, sp_cls, 1e-3, 0.995)
    # M batches in one call: one-key segments (the tracker's flushes: 10
    # the suite's mean, 349 its largest), random cuts with empty segments,
    # the small path's limit and one slot past it (the large path)
    for m in (2, 10, 349):
        cases[f"hist [8,32] M={m} one-key segments"] = case(
            C_BENCH, B, *log_uniform(m, C_BENCH), 1e-3, 0.995,
            np.arange(1, m + 1))
    cases["hist [8,32] N=2000 M=64, 16 empty"] = case(
        C_BENCH, B, *log_uniform(2000, C_BENCH), 1e-3, 0.995,
        cuts(2000, 64, 16))
    cases["hist [8,32] N=7 M=40, leading/trailing empty"] = case(
        C_BENCH, B, *log_uniform(7, C_BENCH), 1e-3, 0.995,
        [0] * 5 + [1, 1, 3, 3, 3] + [7] * 30)
    cases[f"hist [8,32] N={limit} M=300 (small path's limit)"] = case(
        C_BENCH, B, *log_uniform(limit, C_BENCH), 1e-3, 0.995,
        cuts(limit, 300, 20))
    cases[f"hist [8,32] N={limit} (limit, small path)"] = case(
        C_BENCH, B, *log_uniform(limit, C_BENCH), 1e-3, 0.995)
    cases[f"hist [8,32] N={limit + 1} (large path)"] = case(
        C_BENCH, B, *log_uniform(limit + 1, C_BENCH), 1e-3, 0.995, [limit + 1])
    # the most cells the kernel takes: 12 a thread, chunks of 4 segments
    c_max = sketch_ops.MAX_CELLS // B
    cases[f"hist [{c_max},32] N=1000 M=22 (most cells)"] = case(
        c_max, B, *log_uniform(1000, c_max), 1e-3, 0.995, cuts(1000, 22, 3))
    cases[f"hist [{c_max},32] N={SKETCH_N_STEP} (most cells, large path)"] \
        = case(c_max, B, *log_uniform(SKETCH_N_STEP, c_max), 1e-3, 0.995)
    results = {}

    def check(label, again=""):
        h, iv, cls, kw, ends = cases[label]
        e = None if ends is None else ends.to(dev)
        got = reuse_sketch_update(h.to(dev), iv.to(dev), cls.to(dev),
                                  ends=e, **kw)
        if label not in results:
            want = reference_reuse_sketch(h.to(dev), iv.to(dev),
                                          cls.to(dev), ends=e, **kw)
            host = reference_reuse_sketch(h, iv, cls, ends=ends, **kw)
            results[label] = (want, host)
        want, host = results[label]
        torch.cuda.synchronize()
        same = torch.equal(got.view(torch.int32), want.view(torch.int32))
        same_host = torch.equal(got.cpu().view(torch.int32),
                                host.view(torch.int32))
        assert same and same_host, f"reuse_sketch {label}{again}: not " \
            f"bit-exact (card plain {same}, host plain {same_host})"
        n, m = iv.numel(), 1 if ends is None else ends.numel()
        path = "small" if sketch_ops.small_path(n) else "large"
        print(f"  check reuse_sketch      {label + again:50s} bit-exact vs "
              f"plain (card and host) ok; {path} path, M={m}")

    for label in cases:
        check(label)
    # the large path right after large-path calls (its ticket and counts
    # must be back at zero) and the small path between them, each call a
    # bitwise repeat of its first
    for label in (f"hist [8,32] N={limit + 1} (large path)",
                  "hist [4,32] N=2^20 log-uniform",
                  f"hist [4,32] N={SKETCH_N_STEP} log-uniform",
                  "hist [8,32] M=349 one-key segments",
                  "hist [4,32] N=2^20 log-uniform"):
        check(label, again=" (again)")
    # one segment whose end stops short of N: both paths count the slots
    # before it, as the plain version does on those slots alone
    for n in (limit, limit + 1):
        h, iv, cls, kw, _ = case(C_BENCH, B, *log_uniform(n, C_BENCH), 1e-3,
                                 0.995)
        k = n // 2
        got = reuse_sketch_update(
            h.to(dev), iv.to(dev), cls.to(dev),
            ends=torch.tensor([k], dtype=torch.int32, device=dev), **kw)
        want = reference_reuse_sketch(h, iv[:k], cls[:k], **kw)
        assert torch.equal(got.cpu().view(torch.int32),
                           want.view(torch.int32)), \
            f"reuse_sketch N={n} ends=[{k}]: not the first {k} slots' sketch"
        path = "small" if sketch_ops.small_path(n) else "large"
        print(f"  check reuse_sketch      N={n} ends=[{k}] (short end)"
              f"{'':20s} bit-exact vs plain on the first {k} slots ok; "
              f"{path} path")

    # times: one batch at the bench's shape, the suite's mean and largest
    # flush, the small path's limit and one past, the control plane's
    def inputs(C, n, m=1):
        """4 sets of (hist, intervals, class_ids, kw, ends) on the card;
        m > 1: one-key segments (m == n)"""
        sets = []
        for _ in range(4):
            h, iv, cls, kw, _ = case(C, B, *log_uniform(n, C), 1e-3, 0.995)
            ends = None if m == 1 else torch.arange(
                1, n + 1, dtype=torch.int32, device=dev)
            sets.append((h.to(dev), iv.to(dev), cls.to(dev), kw, ends))
        return sets

    def timed(C, n, m=1):
        sets = inputs(C, n, m)
        b_ms, b_by = _bound_ms(8 * n + 8 * C * B + (4 * m if m > 1 else 0),
                               0, torch.float32)

        def calls(fn):
            return [lambda s=s: fn(s[0], s[1], s[2], ends=s[4], **s[3])
                    for s in sets]
        return dict(
            shape=f"hist [{C},{B}] f32, intervals [{n}] f32, class_ids "
                  f"[{n}] i32" + (f", ends [{m}] i32" if m > 1 else ""),
            max_abs_err=0.0,
            ms=_time_ms(calls(reuse_sketch_update)),
            launch_ms=_time_ms(calls(reuse_sketch_update), queued=False),
            plain_ms=_time_ms(calls(reference_reuse_sketch),
                              iters=4 if m > 1 else 20),
            library_ms=None, library="none: no PyTorch call computes a "
            "decayed per-class log-bucket histogram",
            bound_ms=b_ms, bound_by=b_by)
    rec = timed(C_BENCH, 1)
    for r in (rec, timed(C_BENCH, 10, 10), timed(C_BENCH, 349, 349),
              timed(C_BENCH, limit), timed(C_BENCH, limit + 1),
              timed(C_PLANE, SKETCH_N_STEP), timed(C_PLANE, 1 << 20)):
        print(f"  time  reuse_sketch      {r['shape']}: kernel_ms="
              f"{r['ms']:.6f} (with host launch {r['launch_ms']:.6f}) "
              f"plain_ms={r['plain_ms']:.6f} library_ms=none "
              f"bound_ms={r['bound_ms']:.8f} ({r['bound_by']})")

    # (b) the admission benchmark on the card, then on the host
    trackers = []
    init = ReuseTracker.__init__

    def spy(self, *a, **kw):
        init(self, *a, **kw)
        trackers.append(self)

    suite_kw = dict(n_steps=240, step_time=0.25, l_blk=128 << 10,
                    dram_frac=0.35, alpha_accel=4.0, seed=SEED)
    params = {"scenarios": ["zipf", "scan_flood", "diurnal",
                            "multi_tenant"], "n_steps": 240,
              "step_time_ms": 250.0, "l_blk_kib": 128.0, "dram_frac": 0.35,
              "alpha_accel": 4.0, "seed": SEED}
    ReuseTracker.__init__ = spy
    try:
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t1 = time.perf_counter()
        on_card = run_suite(device="cuda", **suite_kw)
        torch.cuda.synchronize()
        wall_card = time.perf_counter() - t1
        launches = kernels.launch_counts()["reuse_sketch"]
        flushes = sum(t.flushes for t in trackers)
    finally:
        ReuseTracker.__init__ = init
    observed = sum(t.observed for t in trackers)
    assert all(t.hist.is_cuda for t in trackers) and len(trackers) == 4
    t1 = time.perf_counter()
    on_host = run_suite(device="cpu", **suite_kw)
    wall_host = time.perf_counter() - t1
    js_card = bench_json(dict(on_card, params=params))
    js_host = bench_json(dict(on_host, params=params))
    assert js_card == js_host, "admission benchmark differs between devices"
    # one launch per flush of a tracker's pending observes, far fewer than
    # one per observe
    assert 0 < launches == flushes < observed, (launches, flushes, observed)
    print(f"  admission benchmark, 4 scenarios x 240 steps: gate wins "
          f"{on_card['wins']}/{on_card['cells']}; bench_json identical on "
          f"cuda and cpu (sha256 "
          f"{hashlib.sha256(js_card.encode()).hexdigest()[:16]}); "
          f"observes {observed}, flushes {flushes}, reuse_sketch launches "
          f"{launches} == flushes; wall {wall_card:.3f} s on cuda, "
          f"{wall_host:.3f} s on cpu ({wall_card / observed * 1e6:.1f} us "
          f"per observe on cuda)")
    for cell in on_card["scenarios"]:
        g = cell["runs"]["economic"]
        print(f"    {cell['scenario']:12s} gate_wins={cell['gate_wins']} "
              f"cost_per_token={g['cost_per_token']!r} per_token_stall="
              f"{g['per_token_stall']!r} best static {cell['best_static']}"
              f" (cost x{cell['cost_ratio_vs_best_static']:.4f})")
    assert on_card["wins"] >= 3, on_card["wins"]

    # (c) a control plane at the scale replay's size, on both devices
    trs = {d: ReuseTracker(ghost_capacity=1_000_000, n_buckets=B,
                           max_classes=C_PLANE, device=d)
           for d in ("cuda", "cpu")}
    ghost_s = []
    ghost = trs["cuda"]._last_seen
    touch = ghost.touch_batch

    def timed_touch(keys, now):
        t = time.perf_counter()
        out = touch(keys, now)
        ghost_s.append(time.perf_counter() - t)
        return out

    ghost.touch_batch = timed_touch
    kv, obj = (trs["cuda"].class_id(c) for c in ("kv", "obj"))
    for tr in trs.values():
        assert (tr.class_id("kv"), tr.class_id("obj")) == (kv, obj)
    walls, dev_ms = [], []
    for step in range(PLANE_STEPS):
        ids = (rng.zipf(1.1, SKETCH_N_STEP) - 1) % PLANE_KEYS
        keys = ids.tolist()
        cids = np.where(ids < PLANE_KV, kv, obj).astype(np.int32)
        now = 0.25 * step
        hist_before = trs["cuda"].hist
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        iv_card = trs["cuda"].observe_batch(keys, cids, now)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t1)
        iv_host = trs["cpu"].observe_batch(keys, cids, now)
        assert np.array_equal(iv_card.view(np.int32), iv_host.view(np.int32))
        assert torch.equal(trs["cuda"].hist.cpu().view(torch.int32),
                           trs["cpu"].hist.view(torch.int32)), step
        for c in ("kv", "obj"):
            assert trs["cuda"].class_quantile(c) == \
                trs["cpu"].class_quantile(c), (step, c)
        iv_d = torch.from_numpy(iv_card).to(dev)
        c_d = torch.from_numpy(cids).to(dev)
        dev_ms.append(_time_ms([lambda: reuse_sketch_update(
            hist_before, iv_d, c_d, tau0=1e-3, decay=0.995)], iters=10))
    tr = trs["cuda"]
    print(f"  control plane: {PLANE_STEPS} steps x {SKETCH_N_STEP} keys "
          f"(Zipf 1.1 over {PLANE_KEYS} ids), ghost {len(tr._last_seen)} "
          f"keys, {tr.measured} of {tr.observed} measured; intervals, "
          f"hist (bit for bit) and class_quantile equal on cuda and cpu at "
          f"every step; median kv {tr.class_quantile('kv')!r} s, obj "
          f"{tr.class_quantile('obj')!r} s")
    print(f"  per step: ghost (host) {np.median(ghost_s) * 1e3:.3f} ms "
          f"median [{min(ghost_s) * 1e3:.3f}, {max(ghost_s) * 1e3:.3f}]; "
          f"observe_batch on cuda {np.median(walls) * 1e3:.3f} ms median; "
          f"sketch kernel (device) {np.median(dev_ms):.6f} ms median "
          f"[{min(dev_ms):.6f}, {max(dev_ms):.6f}]")
    print(f"  phase 8 wall {time.perf_counter() - t0:.1f} s")
    return launches, rec


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build

    # float32 products in full float32 on both paths
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # phase 1: the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    print(f"[1] torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, devices {torch.cuda.device_count()}")

    # phase 2: build
    built = _build.build()
    print(f"[2] built {len(_build.SOURCES)} kernels in "
          f"{built['seconds']:.1f} s")
    for name, log in built["logs"].items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    cfg = get_config("gemma-2b")
    rng = np.random.default_rng(SEED)
    prompts = _prompts(cfg.vocab, N_REQUESTS + 2, rng)
    # decode-step lengths of the first slot grid, a few steps in
    lengths_main = torch.tensor([len(p) + 8 for p in prompts[:MAX_SLOTS]],
                                dtype=torch.int32, device="cuda")

    # the engine's prefill lengths: prompts padded to powers of two
    buckets = sorted({min(1 << (len(p) - 1).bit_length(), MAX_LEN - 1)
                      for p in prompts})
    print("[3] kernels vs plain versions on the card")
    rec = phase_kernels(cfg, lengths_main, buckets)
    print("[4] full-width gemma-2b serving through the kernels and tiers")
    counts = phase_serving(cfg, prompts)
    print("[5] reduced gemma-2b, float32, kernels vs plain path")
    phase_reduced(rng)
    print("[6] cuckoo KV store: demo scenario and a 2^23 x 8 table")
    counts["cuckoo_probe"], rec["cuckoo_probe"] = phase_kvstore()
    print("[7] two-stage ANN search over 262,144 vectors")
    counts["ann_topk"], rec["ann_topk"] = phase_ann()
    print("[8] autopilot: reuse sketch, admission benchmark, control plane")
    counts["reuse_sketch"], rec["reuse_sketch"] = phase_autopilot()
    for name in ("cuckoo_probe", "ann_topk", "reuse_sketch"):
        r = rec[name]
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        print(f"  time  {name:17s} {r['shape']}: kernel_ms={r['ms']:.4f} "
              f"(with host launch {r['launch_ms']:.4f}) plain_ms="
              f"{r['plain_ms']:.4f} library_ms={lib} ({r['library']}) "
              f"bound_ms={r['bound_ms']:.6g} ({r['bound_by']}); "
              f"launches {counts[name]}")
        assert counts[name] > 0, f"{name} kernel never launched on its path"

    line = {"kernels": [
        dict(name=name, route="cuda", source=KERNELS[name][0],
             replaces=KERNELS[name][1], launches=counts[name],
             max_abs_err=r["max_abs_err"], ms=r["ms"],
             plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
             bound_by=r["bound_by"], library_ms=r["library_ms"],
             shape=r["shape"])
        for name, r in rec.items()]}
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
