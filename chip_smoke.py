#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (`src/repro_torch`) on one GPU.

Drives the port's serving path on the card and checks it, in phases:

  1. the card's name and power limit (exits non-zero without CUDA);
  2. builds the hand-written CUDA kernels from `src/repro_torch/csrc`;
  3. holds each kernel against its plain PyTorch version on the card at
     the serving path's shapes (float32 and bfloat16, ragged lengths, a
     GQA case beside gemma's MQA) and times kernel, plain version, one
     PyTorch library call and the roofline bound;
  4. full-width gemma-2b (random bf16 weights from a seed, full depth)
     serves 6 requests through `DecodeEngine`, then parks two sessions
     through a `TieredStore` whose DRAM holds 1.5 KV blobs, so the colder
     one is demoted to flash and comes back through a prefetch on the
     virtual clock; every serving kernel's launch counter must move;
  5. reduced gemma-2b in float32: the engine's greedy tokens (kernels)
     equal a greedy loop over the plain PyTorch path;
  6. the SSD-resident cuckoo KV store (paper §VII-A): examples/
     kvstore_demo.py's store (8192 buckets x 8 slots, load 0.7) answers
     4096 batched GETs through the probe kernel and a timed store's
     get_many; then a table of 2^23 buckets x 8 slots (512 MiB on the
     card) answers 2^20 probes, half stored and half absent, and the
     kernel is held against its plain version and timed;
  7. two-stage ANN search (paper §VII-B) over 262,144 vectors (full
     1024-d, reduced 128-d) for 1024 queries: recall@10 against exact
     search on the card, ann_topk against its plain version, and
     recall@10 > 0.98 at the reference tests' size (8000 vectors);
  8. the autopilot: the reuse-sketch kernel bit for bit against its plain
     version (on the card and on the host) at the bench's shape, the
     scale replay's (50,000 and 2^20 intervals), an empty batch, every
     bucket edge +-64 ulps and special values; the admission benchmark
     (4 scenarios x 240 steps) on the card, byte-identical to the same
     suite on the CPU, with one kernel launch per observed key; and a
     control plane of 20 steps x 50,000 Zipf keys over 1,000,000 ids
     whose sketch is bit-identical on the card and the host every step.

The line before the last is the kernels' JSON record; the last line is
`{"ok": true, "device": {...}}`. Any failed check raises, and the script
exits non-zero.

    python3 chip_smoke.py
"""
from __future__ import annotations

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
# phase 6: examples/kvstore_demo.py's store, and one at deployment size
KV_DEMO_BUCKETS = 8192
KV_BUCKETS = 1 << 23           # x 8 slots x (key + value) int32 = 512 MiB
KV_SLOTS = 8
KV_LOAD = 0.7
KV_PROBES = 1 << 20
# phase 7: the corpus and queries; the reference tests' size
ANN_N, ANN_D_FULL, ANN_D_RED, ANN_Q = 262_144, 1024, 128, 1024
ANN_PROMOTE, ANN_K = 64, 10
ANN_SMALL = (8000, 100)
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
def phase_kernels(cfg, lengths_main, prompt_main):
    """Kernel vs plain version on the card; returns {name: record}."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import (decode_attention, flash_attention,
                                     rmsnorm)
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
    S_main = min(1 << (len(prompt_main) - 1).bit_length(), MAX_LEN - 1)

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
    # the real path reads one layer's cache after another: 18 distinct
    # caches exceed the 50 MB L2
    caches = [(randn(MAX_SLOTS, KV, MAX_LEN, hd, dtype=torch.bfloat16),
               randn(MAX_SLOTS, KV, MAX_LEN, hd, dtype=torch.bfloat16))
              for _ in range(cfg.n_groups)]
    q = randn(MAX_SLOTS, H, hd, dtype=torch.bfloat16)
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

    # ---- flash attention: causal prefill, MQA and GQA, ragged S, S < T ---
    for dt in (torch.float32, torch.bfloat16):
        for h_, kv_, S, T in ((H, KV, S_main, S_main), (8, 2, 700, 700),
                              (H, KV, 300, 1023)):
            q = randn(1, h_, S, hd, dtype=dt)
            k = randn(1, kv_, T, hd, dtype=dt)
            v = randn(1, kv_, T, hd, dtype=dt)
            errs[(dt, h_, kv_, S, T)] = _check(
                "flash_attention",
                flash_attention(q, k, v, scale=scale),
                reference_attention(q, k, v, scale=scale),
                str(dt).split(".")[1], f"H={h_} KV={kv_} S={S} T={T} {dt}")
        # the prefill's own layout: q a transposed [B,S,H,hd] projection,
        # k and v the first S rows of a max_len cache
        q = randn(1, S_main, H, hd, dtype=dt).transpose(1, 2)
        kc = randn(1, KV, MAX_LEN, hd, dtype=dt)[:, :, :S_main]
        vc = randn(1, KV, MAX_LEN, hd, dtype=dt)[:, :, :S_main]
        _check("flash_attention", flash_attention(q, kc, vc, scale=scale),
               reference_attention(q, kc, vc, scale=scale),
               str(dt).split(".")[1], f"strided views S={S_main} {dt}")
    ins = [(randn(1, H, S_main, hd, dtype=torch.bfloat16),
            randn(1, KV, S_main, hd, dtype=torch.bfloat16),
            randn(1, KV, S_main, hd, dtype=torch.bfloat16))
           for _ in range(4)]
    pairs = S_main * (S_main + 1) // 2
    nbytes = (2 * S_main * H * hd + 2 * S_main * KV * hd) * 2
    b_ms, b_by = _bound_ms(nbytes, 4 * pairs * H * hd, torch.bfloat16)
    rec["flash_attention"] = dict(
        shape=f"q [1,{H},{S_main},{hd}] k,v [1,{KV},{S_main},{hd}] bf16",
        max_abs_err=errs[(torch.bfloat16, H, KV, S_main, S_main)],
        ms=_time_ms([lambda t=t: flash_attention(*t, scale=scale)
                     for t in ins], iters=10),
        launch_ms=_time_ms([lambda t=t: flash_attention(*t, scale=scale)
                            for t in ins], iters=10, queued=False),
        plain_ms=_time_ms([lambda t=t: reference_attention(
            *t, scale=scale) for t in ins], iters=10),
        library_ms=_time_ms([lambda t=t: F.scaled_dot_product_attention(
            *t, is_causal=True, scale=scale, enable_gqa=True)
            for t in ins], iters=10),
        bound_ms=b_ms, bound_by=b_by)
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
    print(f"  launches per prefill {per_prefill}, per decode step "
          f"{kernels.launch_counts()}")
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
    return counts


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


def phase_kvstore():
    """The cuckoo store through its entry points, then the probe kernel at
    deployment size against its plain version. Returns (launches, record)."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.kernels.cuckoo_probe import (cuckoo_probe, hash_pair,
                                                  reference_cuckoo_probe)
    from repro_torch.kvstore import BlockedCuckooStore, TimedCuckooStore

    t0 = time.perf_counter()
    # (a) examples/kvstore_demo.py's scenario
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
    probe = keys[rng.integers(0, n, 4096)].astype(np.int32)
    kernels.reset_launch_counts()
    found, vals = store.get_batch(probe)
    launches = kernels.launch_counts()["cuckoo_probe"]
    assert found.all() and (vals == probe % 99991).all(), "demo GETs wrong"
    pf, pv = store.get_batch(probe, use_kernel=False)
    assert (pf == found).all() and (pv == vals).all()
    print(f"  demo store: {n} items at load {store.load_factor():.4f}, "
          f"{store.stats.relocations} relocations; batched GET x"
          f"{len(probe)} through the kernel: all found, all values right, "
          f"== plain version; {store.stats}")
    got = timed.get_many(probe[:100].tolist())
    assert got == [int(k) % 99991 for k in probe[:100]]
    print(f"  timed store get_many x100: modeled {timed.clock.now()!r} s\n"
          + "\n".join("    " + line
                      for line in timed.modeled_report().splitlines()))

    # (b) 2^23 buckets x 8 slots on the card, filled to ~0.7
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    n_fill = int(KV_BUCKETS * KV_SLOTS * KV_LOAD)
    half = KV_PROBES // 2
    pool = torch.unique(torch.randint(1, 2**31 - 1, (n_fill + n_fill // 8,),
                                      generator=gen, device=dev))
    pool = pool[torch.randperm(len(pool), generator=gen, device=dev)]
    assert len(pool) >= n_fill + half
    cand, absent = pool[:n_fill], pool[n_fill:n_fill + half]
    cand_vals = (cand * 2654435761 % 2**31).to(torch.int32)
    bk, bv, placed = _fill_table(KV_BUCKETS, KV_SLOTS, cand.to(torch.int32),
                                 cand_vals)
    stored = cand[placed]
    big = BlockedCuckooStore.from_table(bk.cpu().numpy(), bv.cpu().numpy(),
                                        device="cuda")
    probes = []
    for _ in range(4):       # distinct probe sets for timing; set 0 checked
        sel = stored[torch.randperm(len(stored), generator=gen,
                                    device=dev)[:half]]
        p = torch.cat([sel, absent]).to(torch.int32)
        probes.append(p[torch.randperm(len(p), generator=gen, device=dev)])
    print(f"  deployment table: {KV_BUCKETS} buckets x {KV_SLOTS} slots "
          f"({2 * bk.numel() * 4 / 2**20:.0f} MiB on the card), "
          f"{len(stored)} keys placed of {n_fill} (load "
          f"{big.load_factor():.4f})")
    kernels.reset_launch_counts()
    f, v = big.get_batch(probes[0])
    torch.cuda.synchronize()
    launches += kernels.launch_counts()["cuckoo_probe"]
    # the check: kernel == plain version exactly; stored found, absent not
    bk_d, bv_d = big.device_table()
    rf, rv = reference_cuckoo_probe(
        probes[0], *hash_pair(probes[0], KV_BUCKETS), bk_d, bv_d)
    assert torch.equal(f, rf) and torch.equal(v, rv), "kernel != plain"
    want_v = torch.zeros_like(v)
    is_stored = torch.isin(probes[0], stored.to(torch.int32))
    assert int(is_stored.sum()) == half
    assert torch.equal(f.bool(), is_stored), "a stored key was missed or " \
        "an absent one found"
    want_v[is_stored] = (probes[0][is_stored].long() * 2654435761
                         % 2**31).to(torch.int32)
    assert torch.equal(v, want_v), "wrong values"
    print(f"  check cuckoo_probe      {KV_PROBES} probes (half stored) "
          f"max_abs_err=0 (exact) ok: {int(f.sum())} found")
    b1, b2 = hash_pair(probes[0], KV_BUCKETS)
    rows = int(torch.unique(torch.cat([b1, b2])).numel())
    # bytes the lookups need: each probed key, each key row touched once,
    # the hit value, and found + value out
    nbytes = KV_PROBES * 4 + rows * KV_SLOTS * 4 + half * 4 + KV_PROBES * 8
    b_ms, b_by = _bound_ms(nbytes, 0, torch.int32)
    rec = dict(
        shape=(f"keys [{KV_PROBES}] (half stored), table [{KV_BUCKETS},"
               f"{KV_SLOTS}] int32 x2"),
        max_abs_err=0.0,
        ms=_time_ms([lambda p=p: cuckoo_probe(p, bk_d, bv_d)
                     for p in probes]),
        launch_ms=_time_ms([lambda p=p: cuckoo_probe(p, bk_d, bv_d)
                            for p in probes], queued=False),
        plain_ms=_time_ms([lambda p=p: reference_cuckoo_probe(
            p, *hash_pair(p, KV_BUCKETS), bk_d, bv_d) for p in probes],
            iters=8),
        library_ms=None, library="none: no PyTorch call probes a cuckoo "
        "table", bound_ms=b_ms, bound_by=b_by)
    print(f"  phase 6 wall {time.perf_counter() - t0:.1f} s")
    return launches, rec


# ---------------------------------------------------------------- phase 7
def _separated_id_mismatches(d_ref_k1, ids, ids_ref):
    """ids equal wherever the plain version's neighbouring distances (its
    k+1 nearest, so the k-th has a next) differ by more than ANN_TIE."""
    import torch
    gap = d_ref_k1[:, 1:] - d_ref_k1[:, :-1]
    sep = torch.ones_like(ids, dtype=torch.bool)
    sep[:, 1:] &= gap[:, :-1] > ANN_TIE
    sep &= gap > ANN_TIE
    return int(((ids != ids_ref) & sep).sum()), int(sep.sum())


def phase_ann():
    """Two-stage search over the full corpus on the card, ann_topk held
    against its plain version and timed. Returns (launches, record)."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.ann.corpus import make_corpus, make_queries
    from repro_torch.ann.progressive import exact_topk, recall_at_k, search
    from repro_torch.kernels.ann_topk import ann_topk, reference_ann_topk

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

    # ann_topk against its plain version at the path's shapes
    q_red = qs[:, :ANN_D_RED].contiguous()
    errs = []
    for q_, c_, lab in ((q_red, red, f"[{ANN_Q},{ANN_D_RED}] x "
                         f"[{ANN_N},{ANN_D_RED}]"),
                        (torch.from_numpy(small_q[:, :ANN_D_RED]).cuda(),
                         torch.from_numpy(small_red).cuda(),
                         f"[{ANN_SMALL[1]},{ANN_D_RED}] x "
                         f"[{ANN_SMALL[0]},{ANN_D_RED}]")):
        d, ids = ann_topk(q_, c_, k=ANN_PROMOTE)
        rd, rids = reference_ann_topk(q_, c_, ANN_PROMOTE + 1)
        err = float((d - rd[:, :-1]).abs().max())
        bad, n_sep = _separated_id_mismatches(rd, ids, rids[:, :-1])
        assert err <= ANN_ATOL and bad == 0, (lab, err, bad)
        errs.append(err)
        print(f"  check ann_topk          {lab} k={ANN_PROMOTE} "
              f"max_abs_err={err:.3e}; ids equal at all {n_sep} separated "
              f"places ({int((ids != rids[:, :-1]).sum())} near-tie swaps) ok")

    cn = torch.sum(red * red, dim=1)
    nbytes = (q_red.numel() + red.numel()) * 4 + ANN_Q * ANN_PROMOTE * 8
    b_ms, b_by = _bound_ms(nbytes, 2 * ANN_Q * ANN_N * ANN_D_RED,
                           torch.float32)
    out = dict(
        shape=(f"queries [{ANN_Q},{ANN_D_RED}] corpus [{ANN_N},{ANN_D_RED}]"
               f" f32, k={ANN_PROMOTE}"),
        max_abs_err=errs[0],
        ms=_time_ms([lambda: ann_topk(q_red, red, k=ANN_PROMOTE)],
                    iters=10),
        launch_ms=_time_ms([lambda: ann_topk(q_red, red, k=ANN_PROMOTE)],
                           iters=10, queued=False),
        plain_ms=_time_ms([lambda: reference_ann_topk(q_red, red,
                                                      ANN_PROMOTE)],
                          iters=5),
        library_ms=_time_ms([lambda: torch.topk(torch.addmm(
            cn[None, :], q_red, red.T, alpha=-2.0), ANN_PROMOTE,
            largest=False)], iters=10),
        library="torch.addmm(|c|^2, q, c.T, alpha=-2) + torch.topk "
        "(|c|^2 precomputed)",
        bound_ms=b_ms, bound_by=b_by)
    # where stage 1's time goes: the kernel at k = 1 (products, almost no
    # fold) and a bare float32 GEMM of the same shape
    k1_ms = _time_ms([lambda: ann_topk(q_red, red, k=1)], iters=10)
    gemm_ms = _time_ms([lambda: torch.addmm(cn[None, :], q_red, red.T,
                                            alpha=-2.0)], iters=10)
    print(f"  time  ann_topk at k=1 {k1_ms:.4f} ms; torch.addmm alone "
          f"{gemm_ms:.4f} ms (same shape, float32)")
    print(f"  phase 7 wall {time.perf_counter() - t0:.1f} s")
    return launches, out


# ---------------------------------------------------------------- phase 8
def _sketch_edges(tau0: float, n_buckets: int):
    """float32 intervals at tau0 * 2^b for b in -2 .. B+1, and 1 .. 64
    ulps either side of each: where a floor of log2 can go either way."""
    import numpy as np
    base = np.float32(tau0) * np.exp2(np.arange(-2, n_buckets + 2)).astype(
        np.float32)
    steps = np.arange(-64, 65, dtype=np.int64)
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
    """The reuse-sketch kernel bit for bit against its plain version, the
    admission benchmark on the card (byte-identical to the CPU run), and
    a control plane at the scale replay's size. Returns (launches,
    record)."""
    import hashlib

    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.autopilot import ReuseTracker
    from repro_torch.autopilot.bench import run_suite
    from repro_torch.kernels.reuse_sketch import (reference_reuse_sketch,
                                                  reuse_sketch_update)
    from repro_torch.obs import bench_json

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)

    def case(C, B, iv, cls, tau0, decay):
        hist = (rng.random((C, B)) * 7).astype(np.float32)
        return [torch.from_numpy(np.ascontiguousarray(a)) for a in
                (hist, iv.astype(np.float32), cls.astype(np.int32))] + [
            dict(tau0=tau0, decay=decay)]

    def log_uniform(n, C):
        iv = np.power(10.0, rng.uniform(-9.0, 5.0, n)).astype(np.float32)
        return iv, rng.integers(-1, C + 1, n)

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
    sp_iv, sp_cls = _sketch_specials(C_PLANE)
    cases[f"hist [4,32] {sp_iv.size} special values"] = case(
        C_PLANE, B, sp_iv, sp_cls, 1e-3, 0.995)
    for label, (h, iv, cls, kw) in cases.items():
        got = reuse_sketch_update(h.to(dev), iv.to(dev), cls.to(dev), **kw)
        want = reference_reuse_sketch(h.to(dev), iv.to(dev), cls.to(dev),
                                      **kw)
        host = reference_reuse_sketch(h, iv, cls, **kw)
        torch.cuda.synchronize()
        same = torch.equal(got.view(torch.int32), want.view(torch.int32))
        same_host = torch.equal(got.cpu().view(torch.int32),
                                host.view(torch.int32))
        assert same and same_host, f"reuse_sketch {label}: not bit-exact " \
            f"(card plain {same}, host plain {same_host})"
        counted = float((got - torch.full((), kw["decay"], device=dev)
                         * h.to(dev)).sum())
        print(f"  check reuse_sketch      {label:42s} bit-exact vs plain "
              f"(card and host) ok; {counted:.0f} counted")

    # times at the bench's shape and at the control plane's
    def timed(C, n):
        sets = [case(C, B, *log_uniform(n, C), 1e-3, 0.995)
                for _ in range(4)]
        sets = [(h.to(dev), iv.to(dev), cls.to(dev), kw)
                for h, iv, cls, kw in sets]
        nbytes = 8 * n + 8 * C * B
        b_ms, b_by = _bound_ms(nbytes, 0, torch.float32)
        return dict(
            shape=f"hist [{C},{B}] f32, intervals [{n}] f32, class_ids "
                  f"[{n}] i32",
            max_abs_err=0.0,
            ms=_time_ms([lambda s=s: reuse_sketch_update(
                s[0], s[1], s[2], **s[3]) for s in sets]),
            launch_ms=_time_ms([lambda s=s: reuse_sketch_update(
                s[0], s[1], s[2], **s[3]) for s in sets], queued=False),
            plain_ms=_time_ms([lambda s=s: reference_reuse_sketch(
                s[0], s[1], s[2], **s[3]) for s in sets], iters=20),
            library_ms=None, library="none: no PyTorch call computes a "
            "decayed per-class log-bucket histogram",
            bound_ms=b_ms, bound_by=b_by)
    rec = timed(C_BENCH, 1)
    for r in (rec, timed(C_PLANE, SKETCH_N_STEP), timed(C_PLANE, 1 << 20)):
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
    assert launches > 0 and launches == observed, (launches, observed)
    print(f"  admission benchmark, 4 scenarios x 240 steps: gate wins "
          f"{on_card['wins']}/{on_card['cells']}; bench_json identical on "
          f"cuda and cpu (sha256 "
          f"{hashlib.sha256(js_card.encode()).hexdigest()[:16]}); "
          f"reuse_sketch launches {launches} == tracker.observed "
          f"{observed}; wall {wall_card:.3f} s on cuda, {wall_host:.3f} s "
          f"on cpu ({wall_card / observed * 1e6:.1f} us per observe on "
          f"cuda)")
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

    print("[3] kernels vs plain versions on the card")
    rec = phase_kernels(cfg, lengths_main, prompts[0])
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
